// Weight gradient of the 3x3x3 SAME convolution over NDHWC, bf16 in, fp32
// out, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// pcmseg_tpu/ops/pallas/conv3d_grad.py::conv3x3_dw (pl.pallas_call body
// `_dw_kernel`). Same arithmetic: dW[tap, ci, co] = sum over every voxel v of
// the batch of x[v + offset(tap), ci] * dy[v, co], neighbours outside the
// volume read as zero, products of bf16 values summed in fp32.
//
// Formulation: a GEMM with M = 27*Ci rows (tap, ci) (m = tap*Ci + ci,
// tap = (kd*3 + kh)*3 + kw, the (3,3,3,Ci,Co) layout flattened), N = Co
// columns, and K = N*D*H*W voxels. Both operands lie voxel-major in NDHWC
// memory (voxel rows of contiguous channels), so they land in shared memory
// as (k, m) and (k, n) tiles and ldmatrix.trans turns them into mma.sync
// m16n8k16 fragments (bf16 in, fp32 accumulators). Two kernels:
//
//  * halo kernel (Ci % 8 == 0, every conv of the model but the first): a
//    block owns 16 input channels (one m16 tile per tap) x 64 output
//    channels and walks 4x4x8-voxel spatial tiles. For each tile it copies
//    the 6x6x10 halo of x (16 channels) and the tile's dy (64 channels)
//    into shared memory once, zero-filled by cp.async (source size 0)
//    outside the volume instead of reading a padded copy (the TPU kernel's
//    jnp.pad); every tap then reads the halo at its own offset through
//    ldmatrix's per-lane row addresses, so x is read once per tile, not once
//    per tap. Warp w holds taps (kd, kh) = (w / 3, w % 3), kw = 0..2, against
//    all 64 columns: 3 A and 4 B fragment loads per 24 mma.
//  * gather kernel (Ci % 8 != 0: the Ci = 5 input conv, M = 135, rows of 10
//    bytes): 32-voxel k-tiles of the (tap, ci) x co GEMM, the x tile gathered
//    element by element, M padded to the 128-row tile.
//
// What bounds it on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): one
// 128^3 x 64 -> 64 dW is 0.46 TFLOP over 2.1 M voxels; read once, x and dy
// are 0.54 GB, ~850 FLOP per byte, far above the ~295 ridge, so the halo
// kernel is bound by the warp-level mma.sync and shared-memory fragment
// loads (one block of 9 warps per SM: its 96 fp32 accumulators per thread
// leave registers for no second block); wgmma and TMA, the way to the
// card's full rate, are later work. The output is small (1,728 x 64 at
// 64 -> 64), so the voxel sum is split across gridDim.z (split-K) into whole
// waves of blocks and a second pass adds the fp32 partials in a fixed order:
// two runs agree bit for bit. The Ci = 5 input conv is bound by its scalar
// gather. The TPU kernel's H-chunking (_pick_chunk_h) was VMEM bookkeeping
// and has no counterpart.

#include <algorithm>

#include "mma_common.cuh"

namespace {

// ---- gather kernel (Ci % 8 != 0) ------------------------------------------------

constexpr int DW_BM = 128;      // rows (tap, ci) per block
constexpr int DW_BN = 64;       // columns (co) per block
constexpr int DW_BK = 32;       // voxels per pipeline stage
constexpr int DW_STAGES = 4;
constexpr int DW_THREADS = 256;  // 8 warps: 4 along M x 2 along N, 32 x 32 each
constexpr int A_ROW = DW_BM + 8;  // smem row stride of the x tile (272 bytes)
constexpr int B_ROW = DW_BN + 8;  // smem row stride of the dy tile (144 bytes)
constexpr int MIN_STAGES_PER_SPLIT = 16;
constexpr int SMEM_BYTES = DW_STAGES * DW_BK * (A_ROW + B_ROW) * static_cast<int>(sizeof(bf16));

// n / d for n < 2^31 by multiply and shift (PyTorch's IntDivider).
struct FastDiv {
  uint32_t d, m, s;
};

FastDiv make_fastdiv(uint32_t d) {
  uint32_t s = 0;
  while ((1ull << s) < d) ++s;
  const uint64_t m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return {d, static_cast<uint32_t>(m), s};
}

__device__ __forceinline__ uint32_t fdiv(uint32_t n, const FastDiv& f) {
  return (__umulhi(n, f.m) + n) >> f.s;
}

struct Shape {
  FastDiv W, H, D, Ci;
  int V;   // voxels N*D*H*W
  int M;   // 27*Ci
  int Co;
};

// voxel v -> (z, y, x) within its sample
__device__ __forceinline__ void voxel_zyx(int v, const Shape& sh, int& z, int& y, int& x) {
  uint32_t r = fdiv(v, sh.W);
  x = v - static_cast<int>(r * sh.W.d);
  const uint32_t r2 = fdiv(r, sh.H);
  y = static_cast<int>(r - r2 * sh.H.d);
  z = static_cast<int>(r2 - fdiv(r2, sh.D) * sh.D.d);
}

// Neighbour of (z, y, x) at tap offsets (dz, dy, dx) in [-1, 1]: inside?
__device__ __forceinline__ bool inside(int z, int y, int x, int dz, int dy, int dx, const Shape& sh) {
  return static_cast<unsigned>(z + dz) < sh.D.d && static_cast<unsigned>(y + dy) < sh.H.d &&
         static_cast<unsigned>(x + dx) < sh.W.d;
}

// Gather kernel, one block: rows [m0, m0 + 128) x columns [n0, n0 + 64) of
// dW over the voxel stages [kt0, kt0 + stages_per_split); writes its fp32
// sums to dst + blockIdx.z * M * Co (the output itself when there is one
// split).
__global__ void __launch_bounds__(DW_THREADS)
    conv3x3_dw_gather_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                             float* __restrict__ dst, Shape sh, int stages_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);     // [STAGES][BK][A_ROW]
  bf16* Bs = As + DW_STAGES * DW_BK * A_ROW;        // [STAGES][BK][B_ROW]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp >> 1;
  const int warp_n = warp & 1;
  const int m0 = blockIdx.x * DW_BM;
  const int n0 = blockIdx.y * DW_BN;
  const int kt0 = blockIdx.z * stages_per_split;
  const int steps = min(stages_per_split, (sh.V + DW_BK - 1) / DW_BK - kt0);
  const int Ci = static_cast<int>(sh.Ci.d);

  // this thread fills rows [r0, r0 + 16) of voxel kv in the x tile, element
  // by element, and 8 channels of voxel kv in the dy tile, one cp.async
  const int kv = tid >> 3;
  const int r0 = (tid & 7) * 16;
  const int q = tid & 7;
  auto issue = [&](int s) {
    const int v = (kt0 + s) * DW_BK + kv;
    bf16* as = As + (s % DW_STAGES) * DW_BK * A_ROW;
    bf16* bs = Bs + (s % DW_STAGES) * DW_BK * B_ROW;
    int z = 0, y = 0, xx = 0;
    const bool vok = v < sh.V;
    if (vok) voxel_zyx(v, sh, z, y, xx);
    bf16* row = as + kv * A_ROW + r0;
#pragma unroll 4
    for (int j = 0; j < 16; ++j) {
      const int m = m0 + r0 + j;
      bf16 val = __float2bfloat16(0.f);
      if (vok && m < sh.M) {
        const int tap = static_cast<int>(fdiv(m, sh.Ci));
        const int ci = m - tap * Ci;
        const int dz = tap / 9 - 1, dyo = (tap / 3) % 3 - 1, dxo = tap % 3 - 1;
        if (inside(z, y, xx, dz, dyo, dxo, sh)) {
          const long long off = (static_cast<long long>(dz) * sh.H.d + dyo) * sh.W.d + dxo;
          val = x[(static_cast<long long>(v) + off) * Ci + ci];
        }
      }
      row[j] = val;
    }
    const int n = n0 + q * 8;
    const bool ok = vok && n < sh.Co;
    const bf16* src = ok ? dy + static_cast<long long>(v) * sh.Co + n : dy;
    cp_async16(smem_u32(bs + kv * B_ROW + q * 8), src, ok);
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < DW_STAGES - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }

  // ldmatrix.trans addressing: lane l feeds row l%8 of matrix l/8
  const int mat = lane >> 3;
  const int r8 = lane & 7;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<DW_STAGES - 2>();
    __syncthreads();  // stage s landed for every thread; stage s-1's slot is free
    const int pf = s + DW_STAGES - 1;
    if (pf < steps) issue(pf);
    cp_async_commit();

    const bf16* as = As + (s % DW_STAGES) * DW_BK * A_ROW;
    const bf16* bs = Bs + (s % DW_STAGES) * DW_BK * B_ROW;
#pragma unroll
    for (int kk = 0; kk < DW_BK; kk += 16) {
      uint32_t af[2][4];
      uint32_t bfr[4][2];
      // A (m16 x k16, row-major) from the (k, m) tile: matrices
      // (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7), (k 8-15, m 8-15)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int krow = kk + r8 + ((mat >> 1) << 3);
        const int mcol = warp_m * 32 + i * 16 + ((mat & 1) << 3);
        ldmatrix_x4_trans(af[i][0], af[i][1], af[i][2], af[i][3], smem_u32(as + krow * A_ROW + mcol));
      }
      // B (k16 x n8, col-major) from the (k, n) tile, two n8 tiles per load:
      // matrices (k 0-7, n j), (k 8-15, n j), (k 0-7, n j+1), (k 8-15, n j+1)
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const int krow = kk + r8 + ((mat & 1) << 3);
        const int ncol = warp_n * 32 + j * 8 + ((mat >> 1) << 3);
        ldmatrix_x4_trans(bfr[j][0], bfr[j][1], bfr[j + 1][0], bfr[j + 1][1],
                          smem_u32(bs + krow * B_ROW + ncol));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[i][j], af[i], bfr[j]);
    }
  }
  cp_async_wait<0>();

  // C fragment of m16n8: c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at row g + 8
  float* out = dst + static_cast<long long>(blockIdx.z) * sh.M * sh.Co;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + warp_m * 32 + i * 16 + (lane >> 2) + half * 8;
      if (m >= sh.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + warp_n * 32 + j * 8 + (lane & 3) * 2;
        if (col < sh.Co)
          *reinterpret_cast<float2*>(out + static_cast<long long>(m) * sh.Co + col) =
              make_float2(acc[i][j][half * 2], acc[i][j][half * 2 + 1]);
      }
    }
  }
}

// ---- halo kernel (Ci % 8 == 0) ---------------------------------------------------

constexpr int HT_Z = 4, HT_Y = 4, HT_X = 8;  // spatial tile: 128 voxels, 8 k16 groups
constexpr int HH_Y = HT_Y + 2, HH_X = HT_X + 2;
constexpr int H_HALO = (HT_Z + 2) * HH_Y * HH_X;  // 360 rows
constexpr int H_VOX = HT_Z * HT_Y * HT_X;
constexpr int H_CI = 16;   // input channels per block: one m16 tile per tap
constexpr int H_CO = 64;   // output channels per block: 8 n8 tiles
constexpr int H_THREADS = 288;  // 9 warps, warp w = taps (kd, kh) = (w / 3, w % 3), kw = 0..2
constexpr int X_ROW = H_CI + 8;  // 48-byte halo rows: 8 rows hit 8 distinct 16-byte bank groups
constexpr int D_ROW = H_CO + 8;  // 144-byte dy rows
constexpr int H_STAGE = H_HALO * X_ROW + H_VOX * D_ROW;  // elements per pipeline stage
constexpr int H_SMEM = 2 * H_STAGE * static_cast<int>(sizeof(bf16));
constexpr int MIN_TILES_PER_SPLIT = 4;

struct HaloGrid {
  int tiles_z, tiles_y, tiles_x, tiles;  // tiles = N * tiles_z * tiles_y * tiles_x
};

// One block: dW for channels [ci0, ci0 + 16) x [co0, co0 + 64) and all 27 taps,
// summed over the spatial tiles [t0, t0 + tiles_per_split). Each tile's x halo
// (6x6x10 voxels, 16 channels) and dy (4x4x8 voxels, 64 channels) are copied
// into shared memory once; every tap reads the halo at its own offset through
// ldmatrix's per-lane row addresses, so x is read once per tile, not once per
// tap. Tiles are double-buffered with cp.async.
__global__ void __launch_bounds__(H_THREADS, 1)
    conv3x3_dw_halo_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                           float* __restrict__ dst, Shape sh, HaloGrid g, int tiles_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);  // [2][halo rows, then dy rows]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kd = warp / 3, kh = warp % 3;
  const int Ci = static_cast<int>(sh.Ci.d);
  const int D = static_cast<int>(sh.D.d), H = static_cast<int>(sh.H.d), W = static_cast<int>(sh.W.d);
  const int ci0 = blockIdx.x * H_CI;
  const int co0 = blockIdx.y * H_CO;
  const int t0 = blockIdx.z * tiles_per_split;
  const int steps = min(tiles_per_split, g.tiles - t0);

  auto issue = [&](int s) {
    int t = t0 + s;
    const int x0 = (t % g.tiles_x) * HT_X;
    t /= g.tiles_x;
    const int y0 = (t % g.tiles_y) * HT_Y;
    t /= g.tiles_y;
    const int z0 = (t % g.tiles_z) * HT_Z;
    const long long n = t / g.tiles_z;
    bf16* xs = smem + (s & 1) * H_STAGE;
    bf16* ds = xs + H_HALO * X_ROW;
    for (int i = tid; i < H_HALO * 2; i += H_THREADS) {
      const int row = i >> 1, q = i & 1;
      const int hx = row % HH_X, hy = (row / HH_X) % HH_Y, hz = row / (HH_X * HH_Y);
      const int z = z0 + hz - 1, y = y0 + hy - 1, xx = x0 + hx - 1;
      const bool ok = ci0 + q * 8 < Ci && static_cast<unsigned>(z) < static_cast<unsigned>(D) &&
                      static_cast<unsigned>(y) < static_cast<unsigned>(H) &&
                      static_cast<unsigned>(xx) < static_cast<unsigned>(W);
      const bf16* src = ok ? x + (((n * D + z) * H + y) * W + xx) * static_cast<long long>(Ci) + ci0 + q * 8 : x;
      cp_async16(smem_u32(xs + row * X_ROW + q * 8), src, ok);
    }
    for (int i = tid; i < H_VOX * 8; i += H_THREADS) {
      const int row = i >> 3, q = i & 7;
      const int z = z0 + row / (HT_X * HT_Y), y = y0 + (row / HT_X) % HT_Y, xx = x0 + row % HT_X;
      const bool ok = co0 + q * 8 < sh.Co && z < D && y < H && xx < W;
      const bf16* src = ok ? dy + (((n * D + z) * H + y) * W + xx) * static_cast<long long>(sh.Co) + co0 + q * 8 : dy;
      cp_async16(smem_u32(ds + row * D_ROW + q * 8), src, ok);
    }
  };

  float acc[3][8][4];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][j][e] = 0.f;

  // ldmatrix.trans addressing: lane l feeds row l%8 of matrix l/8
  const int mat = lane >> 3;
  const int r8 = lane & 7;
  const int a_k = r8 + ((mat >> 1) << 3);  // this lane's voxel (k) row within a k16 group, A
  const int a_m = (mat & 1) << 3;          // its channel column offset, A
  const int b_k = r8 + ((mat & 1) << 3);   // B
  const int b_n = (mat >> 1) << 3;

  if (steps > 0) issue(0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) issue(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile s landed for every thread
    const bf16* xs = smem + (s & 1) * H_STAGE;
    const bf16* ds = xs + H_HALO * X_ROW;
#pragma unroll 2
    for (int j = 0; j < H_VOX / 16; ++j) {
      const int v = j * 16 + a_k;  // voxel of the tile: x fastest, then y, then z
      const int hrow = ((v / (HT_X * HT_Y) + kd) * HH_Y + (v / HT_X) % HT_Y + kh) * HH_X + v % HT_X;
      uint32_t af[3][4];
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
        ldmatrix_x4_trans(af[kw][0], af[kw][1], af[kw][2], af[kw][3],
                          smem_u32(xs + (hrow + kw) * X_ROW + a_m));
      uint32_t bfr[8][2];
#pragma unroll
      for (int jn = 0; jn < 8; jn += 2)
        ldmatrix_x4_trans(bfr[jn][0], bfr[jn][1], bfr[jn + 1][0], bfr[jn + 1][1],
                          smem_u32(ds + (j * 16 + b_k) * D_ROW + jn * 8 + b_n));
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) mma_bf16_16816(acc[kw][jn], af[kw], bfr[jn]);
    }
    __syncthreads();  // every warp is done with buffer s & 1 before tile s + 2 is issued into it
  }
  cp_async_wait<0>();

  // C fragment of m16n8: c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at row g + 8;
  // rows are channels ci, columns output channels co
  float* out = dst + static_cast<long long>(blockIdx.z) * sh.M * sh.Co;
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
    const int tap = (kd * 3 + kh) * 3 + kw;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = ci0 + (lane >> 2) + half * 8;
      if (ci >= Ci) continue;
      const long long m = static_cast<long long>(tap) * Ci + ci;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const int col = co0 + jn * 8 + (lane & 3) * 2;
        if (col < sh.Co)
          *reinterpret_cast<float2*>(out + m * sh.Co + col) =
              make_float2(acc[kw][jn][half * 2], acc[kw][jn][half * 2 + 1]);
      }
    }
  }
}

// out = the sum of the split-K partials, added in split order (deterministic).
__global__ void dw_reduce(const float4* __restrict__ workspace, float4* __restrict__ out,
                          long long count4, int splits) {
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
  bool halo;
  int grid_x, grid_y, splits, per_split;  // per_split: stages (GEMM) or tiles (halo)
  HaloGrid g;
  long long workspace_bytes;
};

// Split the voxel sum until there are about `want` blocks (at most `want`
// when `whole_waves`, so the last wave is not left nearly empty), keeping
// each split at least `min_per_split` units (stages or tiles) long.
void split(DwPlan& p, long long units, long long want, int min_per_split, bool whole_waves) {
  const long long blocks = static_cast<long long>(p.grid_x) * p.grid_y;
  p.splits = 1;
  if (blocks < want)
    p.splits = static_cast<int>(std::max<long long>(
        1, std::min<long long>(whole_waves ? want / blocks : (want + blocks - 1) / blocks,
                               units / min_per_split)));
  p.per_split = static_cast<int>((units + p.splits - 1) / p.splits);
  p.splits = static_cast<int>((units + p.per_split - 1) / p.per_split);
}

DwPlan make_dw_plan(int N, int D, int H, int W, int Ci, int Co, int sms) {
  DwPlan p{};
  p.halo = Ci % 8 == 0;
  if (p.halo) {
    // one block per SM (288 threads, ~160 registers each): two waves
    p.g.tiles_z = (D + HT_Z - 1) / HT_Z;
    p.g.tiles_y = (H + HT_Y - 1) / HT_Y;
    p.g.tiles_x = (W + HT_X - 1) / HT_X;
    p.g.tiles = N * p.g.tiles_z * p.g.tiles_y * p.g.tiles_x;
    p.grid_x = (Ci + H_CI - 1) / H_CI;
    p.grid_y = (Co + H_CO - 1) / H_CO;
    split(p, p.g.tiles, 2LL * sms, MIN_TILES_PER_SPLIT, true);
  } else {
    // fewer blocks than four per SM: split the voxels
    p.grid_x = (27 * Ci + DW_BM - 1) / DW_BM;
    p.grid_y = (Co + DW_BN - 1) / DW_BN;
    const long long V = static_cast<long long>(N) * D * H * W;
    split(p, (V + DW_BK - 1) / DW_BK, 4LL * sms, MIN_STAGES_PER_SPLIT, false);
  }
  if (p.splits > 1)
    p.workspace_bytes = static_cast<long long>(p.splits) * 27 * Ci * Co * sizeof(float);
  return p;
}

cudaError_t launch_dw(const DwPlan& p, const bf16* x, const bf16* dy, float* dst, const Shape& sh,
                      cudaStream_t stream) {
  const dim3 grid(p.grid_x, p.grid_y, p.splits);
  cudaError_t err;
  if (p.halo) {
    err = set_smem(conv3x3_dw_halo_kernel, H_SMEM);
    if (err != cudaSuccess) return err;
    conv3x3_dw_halo_kernel<<<grid, H_THREADS, H_SMEM, stream>>>(x, dy, dst, sh, p.g, p.per_split);
  } else {
    err = set_smem(conv3x3_dw_gather_kernel, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    conv3x3_dw_gather_kernel<<<grid, DW_THREADS, SMEM_BYTES, stream>>>(x, dy, dst, sh, p.per_split);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of fp32 workspace the launch below needs for this shape on `device`
// (0 unless the voxels are split).
long long pcmseg_conv3x3_dw_workspace_bytes(int N, int D, int H, int W, int Ci, int Co, int device) {
  return make_dw_plan(N, D, H, W, Ci, Co, sm_count(device)).workspace_bytes;
}

// dW (27*Ci, Co) fp32 of x (N, D, H, W, Ci) and dy (N, D, H, W, Co), both bf16,
// on `stream` (PyTorch's current stream) of device `device`. The caller checks
// shapes, dtypes, contiguity and 16-byte alignment, requires Co % 8 == 0 and
// N*D*H*W < 2^31, and passes a workspace of at least
// pcmseg_conv3x3_dw_workspace_bytes(...) bytes. Returns the cudaError_t of the
// launches; does not synchronise.
int pcmseg_conv3x3_dw_bf16(const void* x, const void* dy, void* out, void* workspace,
                           long long workspace_bytes, int N, int D, int H, int W, int Ci, int Co,
                           void* stream, int device) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const DwPlan p = make_dw_plan(N, D, H, W, Ci, Co, sm_count(device));
  if (workspace_bytes < p.workspace_bytes) return static_cast<int>(cudaErrorInvalidValue);
  Shape sh;
  sh.W = make_fastdiv(W);
  sh.H = make_fastdiv(H);
  sh.D = make_fastdiv(D);
  sh.Ci = make_fastdiv(Ci);
  sh.V = N * D * H * W;
  sh.M = 27 * Ci;
  sh.Co = Co;
  auto* ob = static_cast<float*>(out);
  auto* dst = p.splits > 1 ? static_cast<float*>(workspace) : ob;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = launch_dw(p, static_cast<const bf16*>(x), static_cast<const bf16*>(dy), dst, sh, s);
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
  const long long count4 = static_cast<long long>(sh.M) * Co / 4;
  const unsigned blocks = static_cast<unsigned>(std::min<long long>((count4 + 255) / 256, 65535));
  dw_reduce<<<blocks, 256, 0, s>>>(reinterpret_cast<const float4*>(workspace),
                                    reinterpret_cast<float4*>(ob), count4, p.splits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
