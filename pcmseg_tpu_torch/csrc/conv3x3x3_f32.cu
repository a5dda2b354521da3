// Fused 3x3x3 SAME convolution + bias + optional ReLU over NDHWC with fp32
// operands: fp32 x, weight, bias and output, products to fp32 accuracy by
// 3xTF32 on the tensor cores, for Hopper (sm_90a): warpgroup wgmma, A from
// registers, B fed by TMA.
//
// Replaces the fp32 path of the Pallas TPU kernel
// pcmseg_tpu/ops/pallas/conv3d.py::conv3x3x3 (pl.pallas_call body `_kernel`,
// which computes in x's dtype): out = max(sum over the 27 taps of window . W_tap
// + b, 0). With relu off, no bias and the flipped, Ci<->Co-transposed weight
// it is also the convolution's dx. The bf16 path is conv3x3x3.cu.
//
// Formulation: implicit GEMM, M = output voxels, N = Co, K = 27*Ci, with the
// bf16 kernel's packed weight layout, (Co, 27*Ci) row-major, k = tap*Ci + ci,
// tap = (kd*3 + kh)*3 + kw. The wrapper passes it split, as a (2, Co, 27*Ci)
// pair: hi = tf32(w), lo = tf32(w - hi). The kernel takes Ci == 8 or a
// multiple of 64 (the wrapper zero-pads x's channels, as for bf16) and
// Co % 8 == 0.
//
// What bounds it on an H100: a layer does 27*Ci*Co/(Ci+Co)/2 FLOP per byte
// of fp32 x and y, 432 at 64->64, so the arithmetic rate does. The fastest
// fp32-exact rate is 3xTF32, 494.7 / 3 = 165 TFLOP/s (FFMA on the CUDA
// cores: 66.9). Each product a.b is a_lo.b_hi + a_hi.b_lo + a_hi.b_hi with
// hi = tf32(v), lo = tf32(v - hi): the three TF32 wgmma products keep 21 of
// fp32's 24 bits of every product (the dropped lo.lo and lo's own rounding are
// 2^-22 of it), the same function to fp32's accuracy. Design, from the bf16
// kernel's structure:
//
//  * a block owns a BN-wide slice of Co (BN = 128, or 64 when Co is not a
//    multiple of 128) over a (2*MZ)x8x8 (z, y, x) tile of output voxels. Two
//    consumer warpgroups each run m64nBNk8 TF32 wgmma over MZ z-planes (MZ
//    = 2 at BN = 64, 1 at BN = 128), one producer warp issues TMA. One block
//    an SM (198-219 KB of shared memory);
//  * TF32 wgmma reads shared-memory operands K-major only. x in NDHWC is
//    K-major already, but its split must not be written to device memory
//    (a copy of every activation) nor to shared memory (a second halo). So
//    A comes from registers: for each k8 step a consumer loads its fragment
//    (4 values) from the halo with plain shared loads, splits it with
//    cvt.rna.tf32.f32 and issues lo.B_hi, hi.B_lo, hi.B_hi (the small
//    products first, as CUTLASS's 3xTF32 does). Fragments are double-
//    buffered: the next step's loads run while this step's wgmma do;
//  * the halo: for each 32-channel chunk the producer loads the tile's
//    (2*MZ+2)x10x10 x halo by TMA as eight 5-D boxes of 4 channels (16-byte
//    rows): a tap is a start row, x is fetched once per chunk for all 27
//    taps, a warp's fragment loads hit 32 distinct banks, and TMA's zero fill
//    of out-of-volume coordinates is the SAME padding. Two halo buffers: the
//    next chunk's halo lands while this one's 27 taps run;
//  * B, the weight, streams through a ring of stages (one tap x 32 channels:
//    a 128-byte-swizzled hi tile and a lo tile) on full/empty mbarriers;
//  * accuracy: the tensor cores' fp32 sums need not round to nearest. Each
//    stage's 4 k8 steps (12 products a term) go into a fresh accumulator
//    (scale-d 0), which is then added to the running total with one FADD,
//    so no tensor-core sum runs over more than 32 channels of one tap;
//  * Ci = 8 (the padded input conv): one 8-channel halo (two slabs), a k8
//    step is one tap, a stage four (K = 216 in 7 stages, the 28th tap's
//    weight zero by TMA's fill);
//  * layers whose tiles alone cannot fill the card (16^3, 8^3) split the
//    chunks over gridDim.z into an fp32 workspace, and a second pass adds the
//    partials in a fixed order, then bias and ReLU. No atomics: two launches
//    agree bit for bit.
//
// Why not FFMA, the earlier design: exact products on the CUDA cores run at
// 66.9 TFLOP/s, so even at that rate's bound it would take 0.41 of this
// one's bound. A single TF32 wgmma keeps 10 mantissa bits (another
// function); 3xTF32 keeps fp32's.

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int TY = 8, TX = 8;  // output tile rows; z extent 2 * MZ
constexpr int HY = TY + 2, HX = TX + 2;
constexpr int CHUNK = 32;     // channels per halo load
constexpr int THREADS = 288;  // 2 consumer warpgroups + 1 producer warp

template <int BN, bool SMALL>
struct Cfg {
  static constexpr int MZ = BN == 64 ? 2 : 1;  // z-planes per warpgroup
  static constexpr int TZ = 2 * MZ, HZ = TZ + 2;
  static constexpr int SLAB = HZ * HY * HX * 16;  // one 4-channel slab of the halo
  static constexpr int SLABS = SMALL ? 2 : CHUNK / 4;
  static constexpr int HALO = SLABS * SLAB;
  static constexpr int BUFS = SMALL ? 1 : 2;   // halo buffers
  static constexpr int STEPS = SMALL ? 7 : 27;  // weight stages per chunk
  static constexpr int STAGES = BN == 64 ? 4 : 3;
  static constexpr int B_BYTES = BN * 128;  // a 32-column hi or lo weight tile
  static constexpr int STAGE = 2 * B_BYTES;
  static constexpr int HALO_OFF = STAGES * STAGE;
  static constexpr int BAR_OFF = HALO_OFF + BUFS * HALO;
  static constexpr int SMEM = BAR_OFF + 8 * (2 * STAGES + 4) + 1024;  // + alignment slack
};

struct F32Args {
  const float* bias;
  float* out;
  float* workspace;  // split-K partials, or null
  int D, H, W, Ci, Co, relu;
  int tiles_z, tiles_y, tiles_x;
  int chunks_per_split;
  long long M;  // N*D*H*W
};

__device__ __forceinline__ float2 epilogue2(float2 v, const float* bias, int col, int relu) {
  if (bias) {
    v.x += bias[col];
    v.y += bias[col + 1];
  }
  if (relu) {
    v.x = fmaxf(v.x, 0.f);
    v.y = fmaxf(v.y, 0.f);
  }
  return v;
}

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  if constexpr (BN == 64)
    wgmma_m64n64k8_tf32(d, a, db, scale_d);
  else
    wgmma_m64n128k8_tf32(d, a, db, scale_d);
}

// SMALL: Ci == 8 (one 8-channel halo, a tap per k8 step); else Ci % 64 == 0.
template <int BN, bool SMALL>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3x3_f32_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                         const F32Args a) {
  using C = Cfg<BN, SMALL>;
  constexpr int MZ = C::MZ, SLAB = C::SLAB, STEPS = C::STEPS;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzled tiles want 1024
  const uint32_t b_smem = base, halo_smem = base + C::HALO_OFF, bar = base + C::BAR_OFF;
  const float* halo = reinterpret_cast<const float*>(smem_raw + (halo_smem - raw));
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (C::STAGES + s); };
  auto halo_full = [&](int b) { return bar + 8 * (2 * C::STAGES + b); };
  auto halo_empty = [&](int b) { return bar + 8 * (2 * C::STAGES + 2 + b); };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(halo_full(b), 1);
      mbar_init(halo_empty(b), 256);  // every consumer thread, after its last fragment load
    }
    fence_barrier_init();
  }
  __syncthreads();

  int t = blockIdx.x;
  const int x0 = (t % a.tiles_x) * TX;
  t /= a.tiles_x;
  const int y0 = (t % a.tiles_y) * TY;
  t /= a.tiles_y;
  const int z0 = (t % a.tiles_z) * C::TZ;
  const int n = t / a.tiles_z;
  const int n0 = blockIdx.y * BN;
  const int c_begin = blockIdx.z * a.chunks_per_split;
  const int c_end = min(SMALL ? 1 : a.Ci / CHUNK, c_begin + a.chunks_per_split);

  if (tid >= 256) {  // producer warp: one thread issues every TMA load
    if (tid == 256) {
      uint32_t hph[2] = {0, 0};
      auto load_halo = [&](int c) {
        const int b = (c - c_begin) & 1;
        mbar_wait(halo_empty(b), hph[b] ^ 1);
        hph[b] ^= 1;
        mbar_expect_tx(halo_full(b), C::HALO);
        for (int g = 0; g < C::SLABS; ++g)
          tma_load_5d(halo_smem + b * C::HALO + g * SLAB, &xmap, halo_full(b), c * CHUNK + 4 * g, x0 - 1, y0 - 1,
                      z0 - 1, n);
      };
      load_halo(c_begin);
      int s = 0;
      uint32_t ph = 0;
      for (int c = c_begin; c < c_end; ++c) {
        for (int st = 0; st < STEPS; ++st) {
          // the next chunk's halo, once the consumers have left the chunk
          // before this one (the ring has wrapped since its last stage)
          if (!SMALL && st == C::STAGES && c + 1 < c_end) load_halo(c + 1);
          mbar_wait(empty(s), ph ^ 1);
          mbar_expect_tx(full(s), C::STAGE);
          const int k = SMALL ? st * 32 : st * a.Ci + c * CHUNK;
          tma_load_3d(b_smem + s * C::STAGE, &wmap, full(s), k, n0, 0);
          tma_load_3d(b_smem + s * C::STAGE + C::B_BYTES, &wmap, full(s), k, n0, 1);
          if (++s == C::STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg computes z-planes wg * MZ + m of the tile. A
  // fragment row r = 16 * warp + lane / 4 (+ 8) is output voxel (y, x) =
  // (2 * warp (+ 1), lane / 4) of its z-plane; column c = lane % 4 (+ 4)
  // the channel within the k8 step's two 4-channel slabs.
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  int row0[MZ];
#pragma unroll
  for (int m = 0; m < MZ; ++m) row0[m] = ((wg * MZ + m) * HY + 2 * warp) * HX + (lane >> 2);

  // the fragments of k8 step j of stage st from halo buffer b, split hi / lo
  auto load = [&](uint32_t (&f)[MZ][2][4], int b, int st, int j) {
    const int tap = SMALL ? min(st * 4 + j, 26) : st;  // SMALL's tap 27 meets a zero weight
    const int off = ((tap / 9) * HY + (tap / 3) % 3) * HX + tap % 3;
    const float* p = halo + (b * C::HALO + (SMALL ? 0 : 2 * j) * SLAB) / 4 + (lane & 3);
#pragma unroll
    for (int m = 0; m < MZ; ++m) {
      const float* q = p + (row0[m] + off) * 4;
      const float v[4] = {q[0], q[HX * 4], q[SLAB / 4], q[SLAB / 4 + HX * 4]};
#pragma unroll
      for (int i = 0; i < 4; ++i) tf32_split(v[i], f[m][0][i], f[m][1][i]);
    }
  };

  float acc[MZ][BN / 2], total[MZ][BN / 2];
#pragma unroll
  for (int m = 0; m < MZ; ++m) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[m][i] = total[m][i] = 0.f;
    fence_regs(acc[m]);
  }

  // k8 step j of the stage at bs: lo.B_hi, hi.B_lo, hi.B_hi; step 0 starts
  // a fresh accumulator
  auto mma = [&](const uint32_t (&f)[MZ][2][4], uint32_t bs, int j) {
    const uint64_t dhi = gmma_desc(bs + 32 * j, 16, 1024, LAYOUT_B128);
    const uint64_t dlo = gmma_desc(bs + C::B_BYTES + 32 * j, 16, 1024, LAYOUT_B128);
#pragma unroll
    for (int m = 0; m < MZ; ++m) {
      wgmma_tf32<BN>(acc[m], f[m][1], dhi, j > 0);
      wgmma_tf32<BN>(acc[m], f[m][0], dlo, 1);
      wgmma_tf32<BN>(acc[m], f[m][0], dhi, 1);
    }
  };

  uint32_t frag[2][MZ][2][4];
  uint32_t hph[2] = {0, 0};
  int s = 0;
  uint32_t ph = 0;
  mbar_wait(halo_full(0), 0);
  hph[0] = 1;
  load(frag[0], 0, 0, 0);
  for (int c = c_begin; c < c_end; ++c) {
    const int b = (c - c_begin) & 1;
    for (int st = 0; st < STEPS; ++st) {
      mbar_wait(full(s), ph);
      const uint32_t bs = b_smem + s * C::STAGE;
      // fragments double-buffered: a step's loads wait only for the group
      // that read its buffer two steps earlier
      wgmma_fence();
      mma(frag[0], bs, 0);
      wgmma_commit();
      load(frag[1], b, st, 1);
      wgmma_fence();
      mma(frag[1], bs, 1);
      wgmma_commit();
      wgmma_wait<1>();
      load(frag[0], b, st, 2);
      wgmma_fence();
      mma(frag[0], bs, 2);
      wgmma_commit();
      wgmma_wait<1>();
      load(frag[1], b, st, 3);
      wgmma_fence();
      mma(frag[1], bs, 3);
      wgmma_commit();
      wgmma_wait<1>();
      if (st + 1 < STEPS) {
        load(frag[0], b, st + 1, 0);
      } else if (c + 1 < c_end) {  // this chunk's halo is read: on to the next
        mbar_arrive(halo_empty(b));
        mbar_wait(halo_full(b ^ 1), hph[b ^ 1]);
        hph[b ^ 1] ^= 1;
        load(frag[0], b ^ 1, 0, 0);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < MZ; ++m) {
        fence_regs(acc[m]);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) total[m][i] += acc[m][i];
      }
      if ((tid & 127) == 0) mbar_arrive(empty(s));
      if (++s == C::STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
  }

  float* partial = a.workspace ? a.workspace + blockIdx.z * a.M * a.Co : nullptr;
#pragma unroll
  for (int m = 0; m < MZ; ++m) {
    const int z = z0 + wg * MZ + m;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + (lane >> 2) + h * 8;
      const int y = y0 + r / TX, x = x0 + r % TX;
      if (z >= a.D || y >= a.H || x >= a.W) continue;
      const long long v = ((static_cast<long long>(n) * a.D + z) * a.H + y) * a.W + x;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane & 3);
        if (col >= a.Co) continue;
        const float2 p = make_float2(total[m][4 * j + 2 * h], total[m][4 * j + 2 * h + 1]);
        if (partial)
          *reinterpret_cast<float2*>(partial + v * a.Co + col) = p;
        else
          *reinterpret_cast<float2*>(a.out + v * a.Co + col) = epilogue2(p, a.bias, col, a.relu);
      }
    }
  }
}

// Sum the split-K partials in a fixed order, then bias, ReLU.
__global__ void splitk_epilogue_f32(const float2* __restrict__ workspace, const float* __restrict__ bias,
                                    float2* __restrict__ out, long long M, int Co, int splits, int relu) {
  const long long pairs = M * Co / 2;
  for (long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; p < pairs;
       p += static_cast<long long>(gridDim.x) * blockDim.x) {
    float2 s = workspace[p];
    for (int k = 1; k < splits; ++k) {
      const float2 v = workspace[k * pairs + p];
      s.x += v.x;
      s.y += v.y;
    }
    out[p] = epilogue2(s, bias, static_cast<int>((2 * p) % Co), relu);
  }
}

// ---- launch plan -------------------------------------------------------------

struct F32Plan {
  bool small;
  int bn;
  int tiles_z, tiles_y, tiles_x;
  int splits, chunks_per_split;
  long long workspace_bytes;
};

F32Plan make_f32_plan(int N, int D, int H, int W, int Ci, int Co, int sms) {
  F32Plan p{};
  p.small = Ci == 8;
  p.bn = Co % 128 == 0 ? 128 : 64;
  const int tz = p.bn == 64 ? Cfg<64, false>::TZ : Cfg<128, false>::TZ;
  p.tiles_z = (D + tz - 1) / tz;
  p.tiles_y = (H + TY - 1) / TY;
  p.tiles_x = (W + TX - 1) / TX;
  const int chunks = p.small ? 1 : Ci / CHUNK;
  const long long blocks =
      static_cast<long long>(N) * p.tiles_z * p.tiles_y * p.tiles_x * ((Co + p.bn - 1) / p.bn);
  // fewer blocks than two waves (one block per SM): split K over the chunks
  const long long want = 2LL * sms;
  p.splits = blocks < want ? static_cast<int>(std::min<long long>(chunks, (want + blocks - 1) / blocks)) : 1;
  p.chunks_per_split = (chunks + p.splits - 1) / p.splits;
  p.splits = (chunks + p.chunks_per_split - 1) / p.chunks_per_split;
  if (p.splits > 1)
    p.workspace_bytes = static_cast<long long>(p.splits) * N * D * H * W * Co * sizeof(float);
  return p;
}

template <int BN, bool SMALL>
cudaError_t launch(const F32Plan& p, const CUtensorMap& xmap, const CUtensorMap& wmap, const F32Args& a, int N,
                   cudaStream_t stream) {
  auto kernel = conv3x3x3_f32_kernel<BN, SMALL>;
  cudaError_t err = set_smem(kernel, Cfg<BN, SMALL>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(N) * p.tiles_z * p.tiles_y * p.tiles_x),
                  static_cast<unsigned>((a.Co + BN - 1) / BN), static_cast<unsigned>(p.splits));
  kernel<<<grid, THREADS, Cfg<BN, SMALL>::SMEM, stream>>>(xmap, wmap, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of fp32 workspace the launch below needs for this shape on `device`
// (0 unless K is split).
long long pcmseg_conv3x3x3_f32_workspace_bytes(int N, int D, int H, int W, int Ci, int Co, int device) {
  return make_f32_plan(N, D, H, W, Ci, Co, sm_count(device)).workspace_bytes;
}

// Launch on `stream` (PyTorch's current stream) of device `device`. The caller
// checks shapes, dtypes, contiguity and 16-byte alignment, requires Ci == 8
// or Ci % 64 == 0 and Co % 8 == 0, passes the weight as the (2, Co, 27*Ci)
// fp32 pair (hi, lo) of the packed matrix split to TF32, and a workspace of
// at least pcmseg_conv3x3x3_f32_workspace_bytes(...) bytes. Returns the
// cudaError_t of the launches; does not synchronise.
int pcmseg_conv3x3x3_f32(const void* x, const void* w, const void* bias, void* out, void* workspace,
                         long long workspace_bytes, int N, int D, int H, int W, int Ci, int Co, int relu,
                         void* stream, int device) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!(Ci == 8 || Ci % 64 == 0) || Co % 8) return static_cast<int>(cudaErrorInvalidValue);
  const F32Plan p = make_f32_plan(N, D, H, W, Ci, Co, sm_count(device));
  if (workspace_bytes < p.workspace_bytes) return static_cast<int>(cudaErrorInvalidValue);

  CUtensorMap xmap, wmap;
  const int hz = p.bn == 64 ? Cfg<64, false>::HZ : Cfg<128, false>::HZ;
  err = make_ndhwc_map(&xmap, x, N, D, H, W, Ci, 4, HX, HY, hz, false, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cuuint64_t K = static_cast<cuuint64_t>(27) * Ci;
  const cuuint64_t wdims[3] = {K, static_cast<cuuint64_t>(Co), 2};
  const cuuint64_t wstride[2] = {K * sizeof(float), K * Co * sizeof(float)};
  const cuuint32_t wbox[3] = {32, static_cast<cuuint32_t>(p.bn), 1};
  err = make_tensor_map(&wmap, w, 3, wdims, wstride, wbox, true, true);
  if (err != cudaSuccess) return static_cast<int>(err);

  F32Args a;
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.workspace = p.splits > 1 ? static_cast<float*>(workspace) : nullptr;
  a.D = D, a.H = H, a.W = W, a.Ci = Ci, a.Co = Co, a.relu = relu;
  a.tiles_z = p.tiles_z, a.tiles_y = p.tiles_y, a.tiles_x = p.tiles_x;
  a.chunks_per_split = p.chunks_per_split;
  a.M = static_cast<long long>(N) * D * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.small)
    err = p.bn == 64 ? launch<64, true>(p, xmap, wmap, a, N, s) : launch<128, true>(p, xmap, wmap, a, N, s);
  else
    err = p.bn == 64 ? launch<64, false>(p, xmap, wmap, a, N, s) : launch<128, false>(p, xmap, wmap, a, N, s);
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
  const long long pairs = a.M * Co / 2;
  const unsigned blocks = static_cast<unsigned>(std::min<long long>((pairs + 255) / 256, 65535));
  splitk_epilogue_f32<<<blocks, 256, 0, s>>>(static_cast<const float2*>(workspace), a.bias,
                                             static_cast<float2*>(out), a.M, Co, p.splits, relu);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory a block of that launch takes (for tools).
int pcmseg_conv3x3x3_f32_smem_bytes(int Ci, int Co) {
  if (Co % 128 == 0) return Ci == 8 ? Cfg<128, true>::SMEM : Cfg<128, false>::SMEM;
  return Ci == 8 ? Cfg<64, true>::SMEM : Cfg<64, false>::SMEM;
}

}  // extern "C"
