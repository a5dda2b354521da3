// Weight gradient of the 3x3x3 SAME convolution over NDHWC with fp32
// operands: fp32 x and dy, products to fp32 accuracy by 3xTF32 on the tensor
// cores, fp32 out, for Hopper (sm_90a): warpgroup wgmma, A from registers, B
// transposed and split in shared memory, fed by TMA.
//
// Replaces the fp32 path of the Pallas TPU kernel
// pcmseg_tpu/ops/pallas/conv3d_grad.py::conv3x3_dw (pl.pallas_call body
// `_dw_kernel`, "bf16 or fp32" x and dy): dW[tap, ci, co] = sum over every
// voxel v of the batch of x[v + offset(tap), ci] * dy[v, co], neighbours
// outside the volume read as zero. The bf16 path is conv3x3_dw.cu.
//
// Formulation: per tap a GEMM with M = Ci, N = Co and K = the N*D*H*W
// voxels. The kernel takes Ci == 8 or a multiple of 64 (the wrapper zero-pads
// x's channels, as for bf16) and Co % 8 == 0.
//
// What bounds it on an H100: 2*27*Ci*Co FLOP per voxel over 4*(Ci + Co)
// bytes, 432 FLOP per byte at 64 -> 64: the arithmetic rate, at most 3xTF32's
// 165 TFLOP/s for fp32-exact products (FFMA: 66.9). Every product is
// x_lo.dy_hi + x_hi.dy_lo + x_hi.dy_hi with hi = tf32(v), lo = tf32(v - hi)
// (conv3x3x3_f32.cu says why that is fp32's accuracy). Design:
//
//  * in NDHWC both operands are MN-major (channels contiguous, voxels the K
//    rows), and TF32 wgmma takes K-major shared-memory operands only. dy
//    has no tap shift: three transposer warps turn each voxel tile of it
//    into [voxel / 4][co][4] (K-major, no swizzle) in shared memory, split
//    to hi and lo once for all taps, the hi rows and the lo rows side by
//    side. x's tap shift is one voxel, 4 bytes of K, below a descriptor's
//    16-byte start alignment, so x is A from registers: per tap and k8 step
//    a consumer loads its fragment from the x tile with plain shared loads
//    (any shift is an address; fragment rows r and r + 8 are adjacent
//    channels, one 8-byte load) and splits it there. (Reformulating dW^T =
//    dy^T . window would put the shift on the shared B operand instead,
//    where it cannot go.);
//  * a block owns 64 input channels (one m64) x 64 output channels and the
//    three taps kw = 0..2 of one (kd, kh): the x tile is the voxel tile's
//    rows shifted by (kd, kh), 8x10 voxels with the kw halo. The nine (kd,
//    kh) blocks of a voxel range run side by side and share its loads in
//    L2. The producer warpgroup walks 1x8x8-voxel tiles (K = 64): one
//    thread issues TMA into a 4-stage x ring (eight boxes of 8 channels,
//    32-byte rows, so a warp's fragment loads hit 32 distinct banks) and a
//    2-stage dy ring (one box of 64 channels), the transposer warps fill a
//    ring of 3 transposes; full / empty mbarriers pair each ring's writers
//    and readers. TMA's zero fill at out-of-volume coordinates is the SAME
//    padding;
//  * the two consumer warpgroups take alternate tiles, each with a running
//    total per tap, and wait for nothing but their own tile's x and
//    transpose. At the end their totals are added in a fixed order;
//  * a consumer splits each tap's k8 steps of a tile over two
//    accumulators, even and odd: two independent wgmma chains in flight,
//    and sums half as long (the producer warpgroup gives its registers to
//    the consumers, setmaxnreg, to hold them);
//  * accuracy: the tensor cores' fp32 sums need not round to nearest. Each
//    of those sums (SMALL: an m64 tile's over the tile, in one chain) goes
//    into a fresh accumulator (scale-d 0, 12 or 24 products a term), added
//    to the running total with one FADD;
//  * Ci = 8 (the padded input conv): M = 8 is below wgmma's 64 rows, so a
//    block packs (tap, ci) into M, 27 x 8 = 216 rows in four m64 tiles (40
//    rows, 16%, wasted), over the tile's whole 3x10x10 x halo;
//  * the voxel tiles are split over gridDim.z into about two waves of
//    blocks; a second pass adds the split partials in split order. No
//    atomics: two launches agree bit for bit.
//
// What still bounds it (tools/ablate_dw_f32.py): the x fragments' loads
// and splits on each consumer's critical path, redone for every tap, and
// the nine (kd, kh) blocks re-reading each tile from L2; a block holding
// more taps would need more registers for running totals than a consumer
// has.
//
// Why not FFMA, the earlier design: exact products on the CUDA cores run at
// 66.9 TFLOP/s, 0.41 of this bound at best; 3xTF32 computes the same
// function to fp32's accuracy on the tensor cores.

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int TY = 8, TX = 8;  // voxel tile: one z-plane of 8 x rows, a k8 step each
constexpr int HY = TY + 2, HX = TX + 2;
constexpr int VOX = TY * TX;
constexpr int BC = 64;                   // input channels (one m64) and output channels per block
constexpr int DY_BYTES = VOX * BC * 4;   // a dy tile, [voxel][co]
constexpr int DYT_BYTES = VOX * BC * 4;  // its transpose, hi or lo
constexpr int THREADS = 384;             // 2 consumer warpgroups + 1 producer / transposer warpgroup
constexpr int XSTAGES = 4;               // x tiles in flight (two a consumer warpgroup)
constexpr int DSTAGES = 2;               // raw dy tiles in flight
constexpr int TBUFS = 3;                 // dy transposes in flight
constexpr int TRANSPOSERS = 96;          // warps 9-11
constexpr int STEPS = TY;                // k8 steps a tile
constexpr int MIN_TILES_PER_SPLIT = 8;

template <bool SMALL>
struct DwCfg {
  // x per tile: SMALL the whole 3 x HY x HX halo of 8 channels; else the
  // TY x HX rows of one (kd, kh), 64 channels in eight 8-channel slabs
  static constexpr int XVOX = SMALL ? 3 * HY * HX : TY * HX;
  static constexpr int SLABS = SMALL ? 1 : BC / 8;
  static constexpr int SLAB = XVOX * 32;
  static constexpr int X_STAGE = (SLABS * SLAB + 1023) / 1024 * 1024;
  static constexpr int DY_OFF = XSTAGES * X_STAGE;
  static constexpr int T_OFF = DY_OFF + DSTAGES * DY_BYTES;  // transposes: hi and lo each
  static constexpr int BAR_OFF = T_OFF + TBUFS * 2 * DYT_BYTES;
  static constexpr int SMEM = BAR_OFF + 16 * (XSTAGES + DSTAGES + TBUFS) + 1024;  // + alignment slack
  // the running totals of a warpgroup: the m64 tiles (SMALL) or the taps
  // kw; and the fresh accumulators (independent wgmma chains) it sums each
  // one's k8 steps of a tile in, alternately
  static constexpr int UNITS = SMALL ? 4 : 3;
  static constexpr int CHAINS = SMALL ? 1 : 2;
};

struct DwF32Args {
  float* dst;  // (27, Ci, Co) fp32, one slab per split
  int Ci, Co;
  int tiles_z, tiles_y, tiles_x, tiles;
  int tiles_per_split;
};

template <bool SMALL>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_dw_f32_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap dymap,
                          const DwF32Args a) {
  using C = DwCfg<SMALL>;
  constexpr int UNITS = C::UNITS, CHAINS = C::CHAINS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bar = base + C::BAR_OFF;
  unsigned char* gbase = smem_raw + (base - raw);  // generic pointer to `base`
  // full / empty pairs: x stage s, raw dy stage s, transpose buffer s
  auto x_full = [&](int s) { return bar + 8 * s; };
  auto x_empty = [&](int s) { return bar + 8 * (XSTAGES + s); };
  auto dy_full = [&](int s) { return bar + 16 * XSTAGES + 8 * s; };
  auto dy_empty = [&](int s) { return bar + 16 * XSTAGES + 8 * (DSTAGES + s); };
  auto t_full = [&](int s) { return bar + 16 * (XSTAGES + DSTAGES) + 8 * s; };
  auto t_empty = [&](int s) { return bar + 16 * (XSTAGES + DSTAGES) + 8 * (TBUFS + s); };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < XSTAGES; ++s) {
      mbar_init(x_full(s), 1);
      mbar_init(x_empty(s), 1);
    }
    for (int s = 0; s < DSTAGES; ++s) {
      mbar_init(dy_full(s), 1);
      mbar_init(dy_empty(s), 1);
    }
    for (int s = 0; s < TBUFS; ++s) {
      mbar_init(t_full(s), 1);
      mbar_init(t_empty(s), 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int grp = SMALL ? 0 : blockIdx.x % 9;  // (kd, kh)
  const int kd = grp / 3, kh = grp % 3;
  const int ci0 = SMALL ? 0 : (blockIdx.x / 9) * BC;
  const int co0 = blockIdx.y * BC;
  const int t_begin = blockIdx.z * a.tiles_per_split;
  const int tiles = min(a.tiles, t_begin + a.tiles_per_split) - t_begin;  // local tile i is t_begin + i

  if (tid >= 256) {  // the producer warpgroup: TMA (warp 8) and dy's transposes (warps 9-11)
    setmaxnreg_dec<40>();
    if (tid == 256) {
      for (int i = 0; i < tiles; ++i) {
        int r = t_begin + i;
        const int x0 = (r % a.tiles_x) * TX;
        r /= a.tiles_x;
        const int y0 = (r % a.tiles_y) * TY;
        r /= a.tiles_y;
        const int z0 = r % a.tiles_z;
        const int n = r / a.tiles_z;
        const int sx = i % XSTAGES, sd = i % DSTAGES;
        mbar_wait(x_empty(sx), ((i / XSTAGES) & 1) ^ 1);
        const uint32_t xs = base + sx * C::X_STAGE;
        mbar_expect_tx(x_full(sx), C::SLABS * C::SLAB);
        for (int g = 0; g < C::SLABS; ++g) {
          if (SMALL)
            tma_load_5d(xs, &xmap, x_full(sx), 0, x0 - 1, y0 - 1, z0 - 1, n);
          else
            tma_load_5d(xs + g * C::SLAB, &xmap, x_full(sx), ci0 + 8 * g, x0 - 1, y0 - 1 + kh, z0 - 1 + kd, n);
        }
        mbar_wait(dy_empty(sd), ((i / DSTAGES) & 1) ^ 1);
        mbar_expect_tx(dy_full(sd), DY_BYTES);
        tma_load_5d(base + C::DY_OFF + sd * DY_BYTES, &dymap, dy_full(sd), co0, x0, y0, z0, n);
      }
    } else if (tid >= 256 + 32) {
      // dy [voxel][co] -> [voxel / 4][hi co 0..63, lo co 0..63][4]: the two
      // transposes as one 128-row K-major operand, split once a tile
      const int ttid = tid - 256 - 32;
      for (int i = 0; i < tiles; ++i) {
        const int sd = i % DSTAGES, st = i % TBUFS;
        mbar_wait(dy_full(sd), (i / DSTAGES) & 1);
        mbar_wait(t_empty(st), ((i / TBUFS) & 1) ^ 1);
        const float* dyr = reinterpret_cast<const float*>(gbase + C::DY_OFF + sd * DY_BYTES);
        uint4* dyt = reinterpret_cast<uint4*>(gbase + C::T_OFF + st * 2 * DYT_BYTES);
        for (int item = ttid; item < VOX / 4 * BC; item += TRANSPOSERS) {
          const int co = item % BC, vq = item / BC;
          uint32_t h[4], l[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) tf32_split(dyr[(4 * vq + e) * BC + co], h[e], l[e]);
          dyt[vq * 2 * BC + co] = make_uint4(h[0], h[1], h[2], h[3]);
          dyt[vq * 2 * BC + BC + co] = make_uint4(l[0], l[1], l[2], l[3]);
        }
        fence_proxy_async();  // the transposes are read by wgmma (the async proxy)
        named_barrier(4, TRANSPOSERS);
        if (ttid == 0) {
          mbar_arrive(dy_empty(sd));
          mbar_arrive(t_full(st));
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  // consumers: warpgroup wg takes local tiles wg, wg + 2, ... A fragment
  // rows r = 16 * warp + g and r + 8 (g = lane / 4) are input channels
  // ci0 + 16 * warp + 2 * g + {0, 1} (SMALL: rows 64 * u + r, r + 8 of unit
  // u are channels 2 * (g % 4) + {0, 1} of tap 8 * u + 2 * warp + g / 4):
  // adjacent in the x tile, one 8-byte load. Column c = lane % 4 (+ 4) is
  // voxel x = c (+ 4) of the k8 step's x row; step j is row y = j.
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, wtid = tid & 127;
  const int g = lane >> 2, c = lane & 3;

  // the fragments of k8 step j of unit u from the x tile at xs (floats)
  auto load = [&](uint32_t (&f)[2][4], const float* xs, int u, int j) {
    const float* p;  // rows r and r + 8, column c
    if constexpr (SMALL) {
      const int tap = min(8 * u + 2 * warp + (g >> 2), 26);  // rows past tap 26 are dropped
      const int hv = ((tap / 9) * HY + j + (tap / 3) % 3) * HX + tap % 3 + c;
      p = xs + hv * 8 + 2 * (g & 3);
    } else {
      const int hv = j * HX + u + c;  // row j, tap kw = u
      p = xs + (2 * warp + (g >> 2)) * (C::SLAB / 4) + hv * 8 + 2 * (g & 3);
    }
    const float2 v0 = *reinterpret_cast<const float2*>(p);
    const float2 v4 = *reinterpret_cast<const float2*>(p + 32);  // column c + 4: 4 voxels on
    const float v[4] = {v0.x, v0.y, v4.x, v4.y};
#pragma unroll
    for (int i = 0; i < 4; ++i) tf32_split(v[i], f[0][i], f[1][i]);
  };

  float acc[CHAINS][32], total[UNITS][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) acc[k][i] = 0.f;
#pragma unroll
    for (int u = 0; u < UNITS; ++u) total[u][i] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) fence_regs(acc[k]);

  // k8 step q of the transposes at tb: B_hi (64 rows) and B_lo (the next
  // 64), 4 KB a step, the two 4-voxel K halves 2 KB apart, 8-row groups
  // 128 bytes apart
  auto mma = [&](float (&d)[32], const uint32_t (&f)[2][4], uint32_t tb, int q, int first) {
    const uint64_t dhi = gmma_desc(tb + q * 4096, 2048, 128, LAYOUT_INTERLEAVE);
    const uint64_t dlo = gmma_desc(tb + q * 4096 + 1024, 2048, 128, LAYOUT_INTERLEAVE);
    wgmma_m64n64k8_tf32(d, f[1], dhi, !first);
    wgmma_m64n64k8_tf32(d, f[0], dlo, 1);
    wgmma_m64n64k8_tf32(d, f[0], dhi, 1);
  };

  uint32_t frag[2][2][4];
  for (int i = wg; i < tiles; i += 2) {
    const int sx = i % XSTAGES, st = i % TBUFS;
    mbar_wait(x_full(sx), (i / XSTAGES) & 1);
    mbar_wait(t_full(st), (i / TBUFS) & 1);
    const float* xs = reinterpret_cast<const float*>(gbase + sx * C::X_STAGE);
    const uint32_t tb = base + C::T_OFF + st * 2 * DYT_BYTES;

    // fragments double-buffered: a step's loads wait only for the group
    // that read their buffer, two steps earlier
    load(frag[0], xs, 0, 0);
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
#pragma unroll
      for (int j = 0; j < STEPS; ++j) {
        wgmma_fence();
        mma(acc[j % CHAINS], frag[j & 1], tb, j, j < CHAINS);
        wgmma_commit();
        if (j > 0) wgmma_wait<1>();  // the group that read the other buffer is done
        if (j + 1 < STEPS)
          load(frag[(j + 1) & 1], xs, u, j + 1);
        else if (u + 1 < UNITS)
          load(frag[0], xs, u + 1, 0);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int k = 0; k < CHAINS; ++k) {
        fence_regs(acc[k]);
#pragma unroll
        for (int i2 = 0; i2 < 32; ++i2) total[u][i2] += acc[k][i2];
      }
    }
    // every fragment load of this x tile fed a wgmma that has completed, as
    // did every read of the transposes
    if (wtid == 0) {
      mbar_arrive(x_empty(sx));
      mbar_arrive(t_empty(st));
    }
  }

  // warpgroup 1's sums (the odd tiles) added to warpgroup 0's, in this order
  float* comb = reinterpret_cast<float*>(gbase + C::T_OFF);
  named_barrier(3, 256);
  if (wg == 1) {
#pragma unroll
    for (int u = 0; u < UNITS; ++u)
#pragma unroll
      for (int i = 0; i < 32; ++i) comb[(u * 32 + i) * 128 + wtid] = total[u][i];
  }
  named_barrier(3, 256);
  if (wg == 1) return;
#pragma unroll
  for (int u = 0; u < UNITS; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) total[u][i] += comb[(u * 32 + i) * 128 + wtid];

  float* out = a.dst + static_cast<long long>(blockIdx.z) * 27 * a.Ci * a.Co;
#pragma unroll
  for (int u = 0; u < UNITS; ++u) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int tap, ci;
      if constexpr (SMALL) {
        tap = 8 * u + 2 * warp + (g >> 2);
        ci = 2 * (g & 3) + h;
        if (tap >= 27) continue;
      } else {
        tap = (kd * 3 + kh) * 3 + u;
        ci = ci0 + 16 * warp + 2 * g + h;
      }
      float* row = out + (static_cast<long long>(tap) * a.Ci + ci) * a.Co;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = co0 + 8 * j + 2 * c;
        if (co < a.Co)
          *reinterpret_cast<float2*>(row + co) = make_float2(total[u][4 * j + 2 * h], total[u][4 * j + 2 * h + 1]);
      }
    }
  }
}

// out = the sum of the split partials, added in split order (deterministic).
__global__ void dw_reduce_f32(const float4* __restrict__ workspace, float4* __restrict__ out, long long count4,
                              int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < count4;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float4 s = workspace[i];
    for (int k = 1; k < splits; ++k) {
      const float4 v = workspace[k * count4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out[i] = s;
  }
}

struct DwF32Plan {
  bool small;
  int grid_x, grid_y, splits, tiles_per_split;
  int tiles_z, tiles_y, tiles_x, tiles;
  long long workspace_bytes;
};

DwF32Plan make_dw_f32_plan(int N, int D, int H, int W, int Ci, int Co, int sms) {
  DwF32Plan p{};
  p.small = Ci == 8;
  p.tiles_z = D;
  p.tiles_y = (H + TY - 1) / TY;
  p.tiles_x = (W + TX - 1) / TX;
  p.tiles = N * p.tiles_z * p.tiles_y * p.tiles_x;
  p.grid_x = p.small ? 1 : 9 * (Ci / BC);
  p.grid_y = (Co + BC - 1) / BC;
  // one block per SM: split the voxel tiles into about two waves
  const long long blocks = static_cast<long long>(p.grid_x) * p.grid_y;
  p.splits = 1;
  if (blocks < 2LL * sms)
    p.splits = static_cast<int>(
        std::max<long long>(1, std::min<long long>((2LL * sms + blocks - 1) / blocks, p.tiles / MIN_TILES_PER_SPLIT)));
  p.tiles_per_split = (p.tiles + p.splits - 1) / p.splits;
  p.splits = (p.tiles + p.tiles_per_split - 1) / p.tiles_per_split;
  if (p.splits > 1) p.workspace_bytes = static_cast<long long>(p.splits) * 27 * Ci * Co * sizeof(float);
  return p;
}

template <bool SMALL>
cudaError_t launch_dw(const DwF32Plan& p, const CUtensorMap& xmap, const CUtensorMap& dymap, const DwF32Args& a,
                      cudaStream_t stream) {
  auto kernel = conv3x3_dw_f32_kernel<SMALL>;
  cudaError_t err = set_smem(kernel, DwCfg<SMALL>::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.grid_x, p.grid_y, p.splits), THREADS, DwCfg<SMALL>::SMEM, stream>>>(xmap, dymap, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of fp32 workspace the launch below needs for this shape on `device`
// (0 unless the voxels are split).
long long pcmseg_conv3x3_dw_f32_workspace_bytes(int N, int D, int H, int W, int Ci, int Co, int device) {
  return make_dw_f32_plan(N, D, H, W, Ci, Co, sm_count(device)).workspace_bytes;
}

// dW (27*Ci, Co) fp32 of x (N, D, H, W, Ci) and dy (N, D, H, W, Co), both fp32,
// on `stream` (PyTorch's current stream) of device `device`. The caller checks
// shapes, dtypes, contiguity and 16-byte alignment, requires Ci == 8 or
// Ci % 64 == 0, Co % 8 == 0 and N*D*H*W < 2^31, and passes a workspace of at
// least pcmseg_conv3x3_dw_f32_workspace_bytes(...) bytes. Returns the
// cudaError_t of the launches; does not synchronise.
int pcmseg_conv3x3_dw_f32(const void* x, const void* dy, void* out, void* workspace, long long workspace_bytes,
                          int N, int D, int H, int W, int Ci, int Co, void* stream, int device) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!(Ci == 8 || Ci % BC == 0) || Co % 8) return static_cast<int>(cudaErrorInvalidValue);
  const DwF32Plan p = make_dw_f32_plan(N, D, H, W, Ci, Co, sm_count(device));
  if (workspace_bytes < p.workspace_bytes) return static_cast<int>(cudaErrorInvalidValue);

  CUtensorMap xmap, dymap;
  err = p.small ? make_ndhwc_map(&xmap, x, N, D, H, W, Ci, 8, HX, HY, 3, false, CU_TENSOR_MAP_DATA_TYPE_FLOAT32)
                : make_ndhwc_map(&xmap, x, N, D, H, W, Ci, 8, HX, TY, 1, false, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = make_ndhwc_map(&dymap, dy, N, D, H, W, Co, BC, TX, TY, 1, false, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err != cudaSuccess) return static_cast<int>(err);

  DwF32Args a;
  a.dst = p.splits > 1 ? static_cast<float*>(workspace) : static_cast<float*>(out);
  a.Ci = Ci, a.Co = Co;
  a.tiles_z = p.tiles_z, a.tiles_y = p.tiles_y, a.tiles_x = p.tiles_x, a.tiles = p.tiles;
  a.tiles_per_split = p.tiles_per_split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = p.small ? launch_dw<true>(p, xmap, dymap, a, s) : launch_dw<false>(p, xmap, dymap, a, s);
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
  const long long count4 = 27LL * Ci * Co / 4;
  const unsigned blocks = static_cast<unsigned>(std::min<long long>((count4 + 255) / 256, 65535));
  dw_reduce_f32<<<blocks, 256, 0, s>>>(reinterpret_cast<const float4*>(workspace), static_cast<float4*>(out),
                                       count4, p.splits);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory a block of that launch takes (for tools).
int pcmseg_conv3x3_dw_f32_smem_bytes(int Ci) { return Ci == 8 ? DwCfg<true>::SMEM : DwCfg<false>::SMEM; }

}  // extern "C"
