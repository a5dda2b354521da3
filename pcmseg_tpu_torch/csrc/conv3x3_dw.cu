// Weight gradient of the 3x3x3 SAME convolution over NDHWC, bf16 or fp16 in
// (one template, two entry points), fp32 out, for Hopper (sm_90a):
// warpgroup wgmma fed by TMA.
//
// Replaces the Pallas TPU kernel
// pcmseg_tpu/ops/pallas/conv3d_grad.py::conv3x3_dw (pl.pallas_call body
// `_dw_kernel`). Same arithmetic: dW[tap, ci, co] = sum over every voxel v of
// the batch of x[v + offset(tap), ci] * dy[v, co], neighbours outside the
// volume read as zero, products of 16-bit values (exact in fp32, subnormal
// fp16 values included) summed in fp32. fp16 takes the bf16 design
// unchanged: the same instruction shapes at the same rate, the same bytes.
//
// Formulation: per tap a GEMM with M = Ci rows, N = Co columns and K = the
// N*D*H*W voxels. Both operands lie voxel-major in NDHWC memory, so both are
// MN-major wgmma operands (channels contiguous, voxels the K rows). The
// kernel takes Ci == 8 or a multiple of 64 (the wrapper zero-pads x's
// channels, e.g. the Ci = 5 input conv to 8) and Co % 8 == 0.
//
// What bounds it on an H100 (989 TFLOP/s bf16 / fp16 dense, 3.35 TB/s): one
// 128^3 x 64 -> 64 dW is 0.46 TFLOP over 2.1 M voxels; read once, x and dy
// are 0.54 GB, ~850 FLOP per byte, far above the ~295 ridge: bound by the
// tensor cores if x is fetched once per voxel tile for all taps. Design:
//
//  * a block owns 64 input channels x 64 output channels and one kd of the
//    taps; its three consumer warpgroups take kh = 0, 1, 2 and each keeps
//    the three kw taps as three m64n64 fp32 accumulators in registers (96
//    per thread), so 9 taps share every tile of x and dy in shared memory;
//  * one producer thread walks 2x8x8-voxel tiles (K = 128 voxels, eight
//    k16 steps of two x-rows each) through a 4-stage TMA ring on mbarriers:
//    dy as one 5-D box of 64 channels with the 128-byte swizzle, the x halo
//    (2x10x10 voxels, shifted by kd in z) as eight 5-D boxes of 8 channels
//    with 16-byte rows. TMA's zero fill at out-of-volume coordinates is the
//    SAME padding. In the no-swizzle MN-major layout a core matrix is 8 halo
//    voxels adjacent in x by 8 channels, so a tap (kh, kw) is a start
//    address: x is read once per tile, not once per tap, and dy once per
//    (kd, ci block) instead of once per 16 channels;
//  * Ci = 8 (the padded input conv): one block holds all 27 taps. A
//    warpgroup's m64 tile is (kw, ci) for kw = 0..2 at 16-byte steps of the
//    halo (rows 24-63 are discarded), one accumulator per kd;
//  * the voxel sum is split over gridDim.z (split-K) into whole waves of
//    blocks; a second pass adds the fp32 partials in split order, so two
//    runs agree bit for bit. The TPU kernel's H-chunking (_pick_chunk_h)
//    was VMEM bookkeeping and has no counterpart.

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int TZ = 2, TY = 8, TX = 8;  // voxel tile: 128 voxels, k16 step j = z j/4, y rows 2(j%4)..+1
constexpr int HY = TY + 2, HX = TX + 2;
constexpr int VOX = TZ * TY * TX;
constexpr int BC = 64;               // input and output channels per block
constexpr int DY_BYTES = VOX * 128;  // dy tile: 128 voxel rows of 64 channels, 128-byte swizzled
constexpr int THREADS = 416;         // 3 consumer warpgroups (kh) + 1 producer warp
constexpr int STAGES = 4;
constexpr int MIN_TILES_PER_SPLIT = 4;

template <bool SMALL>
struct DwCfg {
  static constexpr int HZ = SMALL ? TZ + 2 : TZ;  // SMALL covers all three kd
  static constexpr int SLABS = SMALL ? 1 : BC / 8;
  static constexpr int SLAB = HZ * HY * HX * 16;
  // + slack: SMALL's discarded rows 24-63 read a few rows past its slab
  static constexpr int STAGE = (DY_BYTES + SLABS * SLAB + 256 + 1023) / 1024 * 1024;
  static constexpr int BAR_OFF = STAGES * STAGE;
  static constexpr int SMEM = BAR_OFF + 16 * STAGES + 1024;  // + alignment slack
};

struct DwArgs {
  float* dst;  // (27, Ci, Co) fp32, one slab per split
  int Ci, Co;
  int tiles_z, tiles_y, tiles_x, tiles;
  int tiles_per_split;
};

// T: the element type of x and dy (bf16 or f16).
template <bool SMALL, typename T>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_dw_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap dymap,
                      const DwArgs a) {
  using C = DwCfg<SMALL>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzled dy tile wants 1024
  const uint32_t bar = base + C::BAR_OFF;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (STAGES + s); };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 3);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int kd = SMALL ? 0 : blockIdx.x % 3;
  const int ci0 = SMALL ? 0 : (blockIdx.x / 3) * BC;
  const int co0 = blockIdx.y * BC;
  const int t_begin = blockIdx.z * a.tiles_per_split;
  const int t_end = min(a.tiles, t_begin + a.tiles_per_split);

  if (tid >= 384) {  // producer warp: one thread issues every TMA load
    if (tid == 384) {
      int s = 0;
      uint32_t ph = 0;
      for (int t = t_begin; t < t_end; ++t) {
        int r = t;
        const int x0 = (r % a.tiles_x) * TX;
        r /= a.tiles_x;
        const int y0 = (r % a.tiles_y) * TY;
        r /= a.tiles_y;
        const int z0 = (r % a.tiles_z) * TZ;
        const int n = r / a.tiles_z;
        mbar_wait(empty(s), ph ^ 1);
        const uint32_t st = base + s * C::STAGE;
        mbar_expect_tx(full(s), DY_BYTES + C::SLABS * C::SLAB);
        tma_load_5d(st, &dymap, full(s), co0, x0, y0, z0, n);
        for (int g = 0; g < C::SLABS; ++g)
          tma_load_5d(st + DY_BYTES + g * C::SLAB, &xmap, full(s), ci0 + 8 * g, x0 - 1, y0 - 1,
                      z0 - 1 + kd, n);
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup kh, accumulators aa = kw (SMALL: aa = kd)
  const int kh = tid >> 7;
  float acc[3][32];
#pragma unroll
  for (int aa = 0; aa < 3; ++aa) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[aa][i] = 0.f;
    fence_regs(acc[aa]);
  }

  int s = 0, prev = -1;
  uint32_t ph = 0;
  for (int t = t_begin; t < t_end; ++t) {
    mbar_wait(full(s), ph);
    wgmma_fence();
    const uint32_t st = base + s * C::STAGE, xs = st + DY_BYTES;
#pragma unroll
    for (int j = 0; j < VOX / 16; ++j) {
      const int zz = j / 4, yy = (j % 4) * 2;
      const uint64_t db = gmma_desc(st + j * 2048, 16, 1024, LAYOUT_B128);
#pragma unroll
      for (int aa = 0; aa < 3; ++aa) {
        // halo row of the step's first voxel, shifted by the tap; the next
        // 8 voxels (y + 1) are HX rows on (LBO), the next 8 channels one
        // slab on (SBO); SMALL: the next 8 M rows are the next kw (16 bytes)
        const int row = SMALL ? ((zz + aa) * HY + yy + kh) * HX : (zz * HY + yy + kh) * HX + aa;
        const uint64_t da = gmma_desc(xs + row * 16, HX * 16, SMALL ? 16 : C::SLAB, LAYOUT_INTERLEAVE);
        wgmma_m64n64k16<1, 1, T>(acc[aa], da, db);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous tile's group is done reading its stage
    if (prev >= 0 && (tid & 127) == 0) mbar_arrive(empty(prev));
    prev = s;
    if (++s == STAGES) {
      s = 0;
      ph ^= 1;
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int aa = 0; aa < 3; ++aa) fence_regs(acc[aa]);

  float* out = a.dst + static_cast<long long>(blockIdx.z) * 27 * a.Ci * a.Co;
  const int lane = tid & 31, warp = (tid >> 5) & 3;
#pragma unroll
  for (int aa = 0; aa < 3; ++aa) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + (lane >> 2) + h * 8;
      int tap, ci;
      if (SMALL) {
        if (r >= 24) continue;
        tap = (aa * 3 + kh) * 3 + r / 8;
        ci = r % 8;
      } else {
        tap = (kd * 3 + kh) * 3 + aa;
        ci = ci0 + r;
      }
      if (ci >= a.Ci) continue;
      float* row = out + (static_cast<long long>(tap) * a.Ci + ci) * a.Co;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = co0 + 8 * j + 2 * (lane & 3);
        if (co < a.Co)
          *reinterpret_cast<float2*>(row + co) = make_float2(acc[aa][4 * j + 2 * h], acc[aa][4 * j + 2 * h + 1]);
      }
    }
  }
}

// out = the sum of the split-K partials, added in split order (deterministic).
__global__ void dw_reduce(const float4* __restrict__ workspace, float4* __restrict__ out, long long count4,
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

struct DwPlan {
  bool small;
  int grid_x, grid_y, splits, tiles_per_split;
  int tiles_z, tiles_y, tiles_x, tiles;
  long long workspace_bytes;
};

DwPlan make_dw_plan(int N, int D, int H, int W, int Ci, int Co, int sms) {
  DwPlan p{};
  p.small = Ci == 8;
  p.tiles_z = (D + TZ - 1) / TZ;
  p.tiles_y = (H + TY - 1) / TY;
  p.tiles_x = (W + TX - 1) / TX;
  p.tiles = N * p.tiles_z * p.tiles_y * p.tiles_x;
  p.grid_x = p.small ? 1 : 3 * (Ci / BC);
  p.grid_y = (Co + BC - 1) / BC;
  // one block per SM: split the voxel tiles into at most one whole wave
  const long long blocks = static_cast<long long>(p.grid_x) * p.grid_y;
  p.splits = 1;
  if (blocks < sms)
    p.splits = static_cast<int>(std::max<long long>(1, std::min<long long>(sms / blocks, p.tiles / MIN_TILES_PER_SPLIT)));
  p.tiles_per_split = (p.tiles + p.splits - 1) / p.splits;
  p.splits = (p.tiles + p.tiles_per_split - 1) / p.tiles_per_split;
  if (p.splits > 1) p.workspace_bytes = static_cast<long long>(p.splits) * 27 * Ci * Co * sizeof(float);
  return p;
}

template <bool SMALL, typename T>
cudaError_t launch_dw(const DwPlan& p, const CUtensorMap& xmap, const CUtensorMap& dymap, const DwArgs& a,
                      cudaStream_t stream) {
  auto kernel = conv3x3_dw_kernel<SMALL, T>;
  cudaError_t err = set_smem(kernel, DwCfg<SMALL>::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.grid_x, p.grid_y, p.splits), THREADS, DwCfg<SMALL>::SMEM, stream>>>(xmap, dymap, a);
  return cudaGetLastError();
}

// The launches of one dW in element type T (the entry points below).
template <typename T>
int run_dw(const void* x, const void* dy, void* out, void* workspace, long long workspace_bytes, int N, int D,
           int H, int W, int Ci, int Co, void* stream, int device) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!(Ci == 8 || Ci % BC == 0) || Co % 8) return static_cast<int>(cudaErrorInvalidValue);
  const DwPlan p = make_dw_plan(N, D, H, W, Ci, Co, sm_count(device));
  if (workspace_bytes < p.workspace_bytes) return static_cast<int>(cudaErrorInvalidValue);

  CUtensorMap xmap, dymap;
  constexpr CUtensorMapDataType type = tensor_map_type<T>();
  err = make_ndhwc_map(&xmap, x, N, D, H, W, Ci, 8, HX, HY, p.small ? TZ + 2 : TZ, false, type);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = make_ndhwc_map(&dymap, dy, N, D, H, W, Co, BC, TX, TY, TZ, true, type);
  if (err != cudaSuccess) return static_cast<int>(err);

  DwArgs a;
  a.dst = p.splits > 1 ? static_cast<float*>(workspace) : static_cast<float*>(out);
  a.Ci = Ci, a.Co = Co;
  a.tiles_z = p.tiles_z, a.tiles_y = p.tiles_y, a.tiles_x = p.tiles_x, a.tiles = p.tiles;
  a.tiles_per_split = p.tiles_per_split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = p.small ? launch_dw<true, T>(p, xmap, dymap, a, s) : launch_dw<false, T>(p, xmap, dymap, a, s);
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
  const long long count4 = 27LL * Ci * Co / 4;
  const unsigned blocks = static_cast<unsigned>(std::min<long long>((count4 + 255) / 256, 65535));
  dw_reduce<<<blocks, 256, 0, s>>>(reinterpret_cast<const float4*>(workspace), reinterpret_cast<float4*>(out),
                                    count4, p.splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of fp32 workspace the launch below needs for this shape on `device`
// (0 unless the voxels are split); the same for both element types.
long long pcmseg_conv3x3_dw_workspace_bytes(int N, int D, int H, int W, int Ci, int Co, int device) {
  return make_dw_plan(N, D, H, W, Ci, Co, sm_count(device)).workspace_bytes;
}

long long pcmseg_conv3x3_dw_f16_workspace_bytes(int N, int D, int H, int W, int Ci, int Co, int device) {
  return make_dw_plan(N, D, H, W, Ci, Co, sm_count(device)).workspace_bytes;
}

// dW (27*Ci, Co) fp32 of x (N, D, H, W, Ci) and dy (N, D, H, W, Co), both bf16
// (both fp16 for the _f16 entry), on `stream` (PyTorch's current stream) of
// device `device`. The caller checks shapes, dtypes, contiguity and 16-byte
// alignment, requires Ci == 8 or Ci % 64 == 0, Co % 8 == 0 and N*D*H*W <
// 2^31, and passes a workspace of at least pcmseg_conv3x3_dw_workspace_bytes(...)
// bytes. Returns the cudaError_t of the launches; does not synchronise.
int pcmseg_conv3x3_dw_bf16(const void* x, const void* dy, void* out, void* workspace, long long workspace_bytes,
                           int N, int D, int H, int W, int Ci, int Co, void* stream, int device) {
  return run_dw<bf16>(x, dy, out, workspace, workspace_bytes, N, D, H, W, Ci, Co, stream, device);
}

int pcmseg_conv3x3_dw_f16(const void* x, const void* dy, void* out, void* workspace, long long workspace_bytes,
                          int N, int D, int H, int W, int Ci, int Co, void* stream, int device) {
  return run_dw<f16>(x, dy, out, workspace, workspace_bytes, N, D, H, W, Ci, Co, stream, device);
}

}  // extern "C"
