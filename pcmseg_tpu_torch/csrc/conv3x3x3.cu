// Fused 3x3x3 SAME convolution + bias + optional ReLU over NDHWC, bf16 in and
// out, fp32 accumulation, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pcmseg_tpu/ops/pallas/conv3d.py::conv3x3x3
// (pl.pallas_call body `_kernel`). Same arithmetic: out = max(sum over the 27
// taps of window . W_tap + b, 0), accumulated in fp32, bias added in fp32, then
// ReLU, then one rounding to bf16.
//
// Formulation: implicit GEMM. M = N*D*H*W output voxels, N = Co, K = 27*Ci with
// k = tap*Ci + ci and tap = (kd*3 + kh)*3 + kw. The weight is pre-packed once per
// load as a (Co, Kpad) row-major bf16 matrix (K zero-padded to a multiple of 32),
// so a weight tile is a plain strided copy. Neighbours outside the volume are
// zero-filled by cp.async (src-size 0) instead of being read from a padded copy.
// That drops the TPU kernel's workarounds: no materialized jnp.pad, no VMEM
// weight limit (K is tiled, so the 56.6 MB 1024->1024 weight streams through),
// no H-chunking, and no Ci % 8 gate.
//
// What bounds it on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): the ridge is
// ~295 FLOP per byte of device memory. With ideal traffic (read x once, write
// y once) a layer does 27*Ci*Co/(Ci+Co) FLOP/byte: 864 for 64->64 at 128^3,
// 125 for the 5->64 input conv (memory-bound), ~500 for the 8^3 bottleneck
// where the weight dominates the bytes. So every layer but the first is
// compute-bound if each activation is fetched once, not 27 times (once per
// tap, as a naive im2col gather does: then L2 bandwidth, not the tensor cores,
// sets the rate). Two kernels:
//
//  * halo kernel (Ci % 8 == 0, every layer of the model but the first): a
//    block owns a 4x4x8 (z, y, x) tile of 128 output voxels. For each
//    32-channel chunk it copies the tile's 6x6x10 halo into shared memory
//    once and serves all 27 taps from it: ldmatrix takes one row address per
//    lane, so a tap is an offset into the halo. The (chunk, tap) weight tiles
//    stream through a 4-stage cp.async ring; the next chunk's halo is in
//    flight while this chunk's 27 taps compute. Activation traffic per voxel
//    drops from 27 reads to 360/128 = 2.8. Channels past Ci in a last,
//    partial chunk are zero-filled in both operands.
//  * gather kernel (Ci % 8 != 0: the Ci = 5 input conv, whose 10-byte voxel
//    rows cannot be copied in 16-byte pieces): each k-tile of A is gathered
//    element by element from the NDHWC input.
//
// Both run warp-level mma.sync m16n8k16 (bf16 in, fp32 accumulators) on
// ldmatrix fragments from padded, bank-conflict-free shared rows. Deep layers
// with few output tiles (16^3, 8^3) split K over the channel chunks across
// gridDim.z into an fp32 workspace and a second pass adds bias and ReLU, so
// those layers fill the 132 SMs. Not yet used: wgmma and TMA, the only way
// to the card's full bf16 rate; that is later work.

#include <algorithm>

#include "mma_common.cuh"

namespace {

constexpr int BM = 128;        // output voxels per block
constexpr int BK = 32;         // K per pipeline stage (one channel chunk of one tap)
constexpr int SROW = BK + 8;   // smem row stride (elements): 80 bytes, so 8 rows
                               // hit 8 distinct 16-byte bank groups in ldmatrix
constexpr int STAGES = 4;
constexpr int THREADS = 256;   // 8 warps

// halo kernel's output tile and its halo
constexpr int TZ = 4, TY = 4, TX = 8;
constexpr int HZ = TZ + 2, HY = TY + 2, HX = TX + 2;
constexpr int HALO = HZ * HY * HX;  // 360 rows

// The warp layout shared by both kernels: 8 warps over a BM x BN tile, each
// warp MT m16 tiles by NT = 4 n8 tiles (32 columns).
template <int BN>
struct Tiling {
  static constexpr int WARPS_N = BN / 32;
  static constexpr int WARPS_M = (THREADS / 32) / WARPS_N;
  static constexpr int WM = BM / WARPS_M;
  static constexpr int MT = WM / 16;
  static constexpr int NT = 4;
  static constexpr int B_CHUNKS = BN * (BK / 8) / THREADS;
};

// Copy the BN x BK weight tile at packed column `kcol` into shared rows;
// columns from `cols` on (a multiple of 8) are zero-filled.
template <int BN>
__device__ __forceinline__ void load_weight_tile(bf16* bs, const bf16* wt, int n0, int Co, int Kpad,
                                                 int kcol, int cols, int tid) {
#pragma unroll
  for (int i = 0; i < Tiling<BN>::B_CHUNKS; ++i) {
    const int cidx = tid + i * THREADS;
    const int r = cidx >> 2;
    const int q = cidx & 3;
    const int n = n0 + r;
    const bool ok = n < Co && q * 8 < cols;
    const bf16* src = ok ? wt + static_cast<long long>(n) * Kpad + kcol + q * 8 : wt;
    cp_async16(smem_u32(bs + r * SROW + q * 8), src, ok);
  }
}

// One BK step of mma.sync: A rows at per-lane shared addresses `a_addr[i]`
// (the lane's row of m16 tile i, already offset to its 8-column half), B
// from the [BN][SROW] tile.
template <int BN>
__device__ __forceinline__ void mma_step(float (&acc)[Tiling<BN>::MT][4][4], const uint32_t* a_addr,
                                         const bf16* bs, int warp_n, int lane) {
  constexpr int MT = Tiling<BN>::MT;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t af[MT][4];
    uint32_t bfr[4][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      ldmatrix_x4(af[i][0], af[i][1], af[i][2], af[i][3], a_addr[i] + kk * 2);
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      const int r = warp_n * 32 + j * 8 + (lane & 7) + ((lane >> 4) << 3);
      const int c = kk + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(bfr[j][0], bfr[j][1], bfr[j + 1][0], bfr[j + 1][1], smem_u32(bs + r * SROW + c));
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[i][j], af[i], bfr[j]);
  }
}

// Epilogue for one accumulator pair (row m, columns col, col+1): with no
// workspace, fp32 acc + fp32 bias, ReLU, one rounding to bf16; with a
// workspace (split K), the raw fp32 partial sum of this K slice.
__device__ __forceinline__ void store_pair(float v0, float v1, long long m, int col, int Co,
                                           const float* bias, int relu, bf16* out, float* partial) {
  if (partial) {
    *reinterpret_cast<float2*>(partial + m * Co + col) = make_float2(v0, v1);
    return;
  }
  if (bias) {
    v0 += bias[col];
    v1 += bias[col + 1];
  }
  if (relu) {
    v0 = fmaxf(v0, 0.f);
    v1 = fmaxf(v1, 0.f);
  }
  *reinterpret_cast<__nv_bfloat162*>(out + m * Co + col) = __floats2bfloat162_rn(v0, v1);
}

// ---- halo kernel (Ci % 8 == 0) -------------------------------------------------

template <int BN>
__global__ void __launch_bounds__(THREADS)
    conv3x3x3_halo_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                          const float* __restrict__ bias, bf16* __restrict__ out,
                          float* __restrict__ workspace, int D, int H, int W, int Ci, int Co,
                          int Kpad, int relu, int tiles_z, int tiles_y, int tiles_x,
                          int chunks_per_split, long long M) {
  using T = Tiling<BN>;
  constexpr int MT = T::MT;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Hs = reinterpret_cast<bf16*>(smem_raw);  // [2][HALO][SROW]
  bf16* Bs = Hs + 2 * HALO * SROW;               // [STAGES][BN][SROW]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp / T::WARPS_N;
  const int warp_n = warp % T::WARPS_N;

  int t = blockIdx.x;
  const int x0 = (t % tiles_x) * TX;
  t /= tiles_x;
  const int y0 = (t % tiles_y) * TY;
  t /= tiles_y;
  const int z0 = (t % tiles_z) * TZ;
  const long long n = t / tiles_z;
  const int n0 = blockIdx.y * BN;
  const int chunk0 = blockIdx.z * chunks_per_split;
  const int nchunks = min((Ci + BK - 1) / BK - chunk0, chunks_per_split);
  const int steps = nchunks * 27;
  float* partial = workspace ? workspace + blockIdx.z * M * Co : nullptr;

  // issue the cp.async copies of step s = (chunk s / 27, tap s % 27): the
  // weight tile, and at a chunk's first tap the chunk's halo
  auto issue = [&](int s) {
    const int c = s / 27;
    const int tap = s - c * 27;
    const int ch = (chunk0 + c) * BK;
    const int cols = min(BK, Ci - ch);  // channels of this chunk that exist
    if (tap == 0) {
      bf16* hs = Hs + (c & 1) * HALO * SROW;
      for (int i = tid; i < HALO * 4; i += THREADS) {
        const int row = i >> 2;
        const int q = i & 3;
        const int hx = row % HX, hy = (row / HX) % HY, hz = row / (HX * HY);
        const int z = z0 + hz - 1, y = y0 + hy - 1, xx = x0 + hx - 1;
        const bool ok =
            q * 8 < cols && z >= 0 && z < D && y >= 0 && y < H && xx >= 0 && xx < W;
        const bf16* src =
            ok ? x + (((n * D + z) * H + y) * W + xx) * static_cast<long long>(Ci) + ch + q * 8 : x;
        cp_async16(smem_u32(hs + row * SROW + q * 8), src, ok);
      }
    }
    load_weight_tile<BN>(Bs + (s % STAGES) * BN * SROW, wt, n0, Co, Kpad, tap * Ci + ch, cols, tid);
  };

  // this lane's A row in each m16 tile, as a halo row for tap (0, 0, 0)
  int a_row[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = warp_m * T::WM + i * 16 + (lane & 15);
    const int tx = r % TX, ty = (r / TX) % TY, tz = r / (TX * TY);
    a_row[i] = (tz * HY + ty) * HX + tx;
  }
  const int a_col = (lane >> 4) * 8;

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step s's tiles landed for every thread; step s-1's ring slot is free
    const int pf = s + STAGES - 1;
    if (pf < steps) issue(pf);
    cp_async_commit();

    const int c = s / 27;
    const int tap = s - c * 27;
    const int tap_off = ((tap / 9) * HY + (tap / 3) % 3) * HX + tap % 3;
    const bf16* hs = Hs + (c & 1) * HALO * SROW;
    uint32_t a_addr[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) a_addr[i] = smem_u32(hs + (a_row[i] + tap_off) * SROW + a_col);
    mma_step<BN>(acc, a_addr, Bs + (s % STAGES) * BN * SROW, warp_n, lane);
  }
  cp_async_wait<0>();

  // C fragment of m16n8: c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at row g + 8
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp_m * T::WM + i * 16 + (lane >> 2) + half * 8;
      const int z = z0 + r / (TX * TY), y = y0 + (r / TX) % TY, xx = x0 + r % TX;
      if (z >= D || y >= H || xx >= W) continue;
      const long long m = ((n * D + z) * H + y) * W + xx;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + warp_n * 32 + j * 8 + (lane & 3) * 2;
        if (col < Co)
          store_pair(acc[i][j][half * 2], acc[i][j][half * 2 + 1], m, col, Co, bias, relu, out,
                     partial);
      }
    }
  }
}

// Sum the split-K partials in a fixed order, then bias, ReLU, bf16.
__global__ void splitk_epilogue(const float* __restrict__ workspace, const float* __restrict__ bias,
                                bf16* __restrict__ out, long long M, int Co, int splits, int relu) {
  const long long pairs = M * Co / 2;
  for (long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; p < pairs;
       p += static_cast<long long>(gridDim.x) * blockDim.x) {
    float2 s = reinterpret_cast<const float2*>(workspace)[p];
    for (int k = 1; k < splits; ++k) {
      const float2 v = reinterpret_cast<const float2*>(workspace + k * M * Co)[p];
      s.x += v.x;
      s.y += v.y;
    }
    const int col = static_cast<int>((2 * p) % Co);
    store_pair(s.x, s.y, 2 * p / Co, col, Co, bias, relu, out, nullptr);
  }
}

// ---- gather kernel (Ci % 8 != 0: the Ci = 5 input conv) -------------------------

struct Voxel {
  long long m;  // flat NDHW index
  int z, y, x;
  bool valid;
};

__device__ __forceinline__ Voxel make_voxel(long long m, long long M, int D, int H, int W) {
  Voxel v;
  v.m = m;
  v.valid = m < M;
  long long r = v.valid ? m : 0;
  v.x = static_cast<int>(r % W);
  r /= W;
  v.y = static_cast<int>(r % H);
  r /= H;
  v.z = static_cast<int>(r % D);
  return v;
}

// Offset (in voxels) of tap `tap` from the centre voxel, and whether the
// neighbour lies inside the volume.
__device__ __forceinline__ bool tap_offset(const Voxel& v, int tap, int D, int H, int W,
                                           long long& off) {
  const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
  const int z = v.z + kd - 1, y = v.y + kh - 1, x = v.x + kw - 1;
  off = (static_cast<long long>(kd - 1) * H + (kh - 1)) * W + (kw - 1);
  return v.valid && z >= 0 && z < D && y >= 0 && y < H && x >= 0 && x < W;
}

// A is gathered one element at a time with plain loads (zero outside the
// volume and past K); B goes through cp.async.
template <int BN>
__global__ void __launch_bounds__(THREADS)
    conv3x3x3_gather_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                            const float* __restrict__ bias, bf16* __restrict__ out, int D, int H,
                            int W, int Ci, int Co, int Kpad, long long M, int relu) {
  using T = Tiling<BN>;
  constexpr int MT = T::MT;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [STAGES][BM][SROW]
  bf16* Bs = As + STAGES * BM * SROW;            // [STAGES][BN][SROW]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp / T::WARPS_N;
  const int warp_n = warp % T::WARPS_N;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 27 * Ci;
  const int KT = Kpad / BK;

  // this thread fills row tid / 2, k half (tid % 2) * 16, of each A tile
  const Voxel row = make_voxel(m0 + (tid >> 1), M, D, H, W);
  const int kh0 = (tid & 1) * 16;

  auto issue = [&](int kt) {
    bf16* as = As + (kt % STAGES) * BM * SROW + (tid >> 1) * SROW + kh0;
#pragma unroll 4
    for (int j = 0; j < 16; ++j) {
      const int k = kt * BK + kh0 + j;
      bf16 v = __float2bfloat16(0.f);
      if (k < K) {
        const int tap = k / Ci;
        long long off = 0;
        if (tap_offset(row, tap, D, H, W, off)) v = x[(row.m + off) * Ci + (k - tap * Ci)];
      }
      as[j] = v;
    }
    load_weight_tile<BN>(Bs + (kt % STAGES) * BN * SROW, wt, n0, Co, Kpad, kt * BK, BK, tid);
  };

  uint32_t a_base[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
    a_base[i] = smem_u32(As + (warp_m * T::WM + i * 16 + (lane & 15)) * SROW + (lane >> 4) * 8);

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) issue(s);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed for every thread; stage kt-1 is free
    const int pf = kt + STAGES - 1;
    if (pf < KT) issue(pf);
    cp_async_commit();

    const uint32_t stage_off = (kt % STAGES) * BM * SROW * sizeof(bf16);
    uint32_t a_addr[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) a_addr[i] = a_base[i] + stage_off;
    mma_step<BN>(acc, a_addr, Bs + (kt % STAGES) * BN * SROW, warp_n, lane);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + warp_m * T::WM + i * 16 + (lane >> 2) + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + warp_n * 32 + j * 8 + (lane & 3) * 2;
        if (col < Co)
          store_pair(acc[i][j][half * 2], acc[i][j][half * 2 + 1], m, col, Co, bias, relu, out,
                     nullptr);
      }
    }
  }
}

// ---- launch plans ----------------------------------------------------------------

struct Plan {
  bool halo;
  int bn;
  int tiles_z, tiles_y, tiles_x;
  int splits, chunks_per_split;
  long long workspace_bytes;
};

Plan make_plan(int N, int D, int H, int W, int Ci, int Co, int sms) {
  Plan p{};
  p.halo = Ci % 8 == 0;
  p.bn = Co <= 64 ? 64 : 128;
  p.splits = 1;
  if (!p.halo) return p;
  p.tiles_z = (D + TZ - 1) / TZ;
  p.tiles_y = (H + TY - 1) / TY;
  p.tiles_x = (W + TX - 1) / TX;
  const int chunks = (Ci + BK - 1) / BK;
  const long long blocks =
      static_cast<long long>(N) * p.tiles_z * p.tiles_y * p.tiles_x * ((Co + p.bn - 1) / p.bn);
  // fewer blocks than two waves of SMs: split K over the channel chunks
  const long long want = 2LL * sms;
  if (blocks < want) {
    p.splits = static_cast<int>(std::min<long long>(chunks, (want + blocks - 1) / blocks));
  }
  p.chunks_per_split = (chunks + p.splits - 1) / p.splits;
  p.splits = (chunks + p.chunks_per_split - 1) / p.chunks_per_split;
  if (p.splits > 1)
    p.workspace_bytes = static_cast<long long>(p.splits) * N * D * H * W * Co * sizeof(float);
  return p;
}

template <int BN>
cudaError_t launch_halo(const Plan& p, const bf16* x, const bf16* w, const float* bias, bf16* out,
                        float* workspace, int N, int D, int H, int W, int Ci, int Co, int Kpad,
                        int relu, cudaStream_t stream) {
  constexpr int smem = (2 * HALO + STAGES * BN) * SROW * static_cast<int>(sizeof(bf16));
  auto kernel = conv3x3x3_halo_kernel<BN>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long M = static_cast<long long>(N) * D * H * W;
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(N) * p.tiles_z * p.tiles_y * p.tiles_x),
                  static_cast<unsigned>((Co + BN - 1) / BN), static_cast<unsigned>(p.splits));
  kernel<<<grid, THREADS, smem, stream>>>(x, w, bias, out, p.splits > 1 ? workspace : nullptr, D, H,
                                          W, Ci, Co, Kpad, relu, p.tiles_z, p.tiles_y, p.tiles_x,
                                          p.chunks_per_split, M);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const long long pairs = M * Co / 2;
  const unsigned blocks = static_cast<unsigned>(std::min<long long>((pairs + 255) / 256, 65535));
  splitk_epilogue<<<blocks, 256, 0, stream>>>(workspace, bias, out, M, Co, p.splits, relu);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_gather(const bf16* x, const bf16* w, const float* bias, bf16* out, int N, int D,
                          int H, int W, int Ci, int Co, int Kpad, int relu, cudaStream_t stream) {
  constexpr int smem = STAGES * (BM + BN) * SROW * static_cast<int>(sizeof(bf16));
  auto kernel = conv3x3x3_gather_kernel<BN>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long M = static_cast<long long>(N) * D * H * W;
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM), static_cast<unsigned>((Co + BN - 1) / BN));
  kernel<<<grid, THREADS, smem, stream>>>(x, w, bias, out, D, H, W, Ci, Co, Kpad, M, relu);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of fp32 workspace the launch below needs for this shape on `device`
// (0 unless K is split).
long long pcmseg_conv3x3x3_workspace_bytes(int N, int D, int H, int W, int Ci, int Co, int device) {
  return make_plan(N, D, H, W, Ci, Co, sm_count(device)).workspace_bytes;
}

// Launch on `stream` (PyTorch's current stream) of device `device`. The caller
// checks shapes, dtypes, contiguity and 16-byte alignment, requires
// Co % 8 == 0, and passes a workspace of at least
// pcmseg_conv3x3x3_workspace_bytes(...) bytes. Returns the cudaError_t of the
// launch; does not synchronise.
int pcmseg_conv3x3x3_bf16(const void* x, const void* w, const void* bias, void* out,
                          void* workspace, long long workspace_bytes, int N, int D, int H, int W,
                          int Ci, int Co, int relu, void* stream, int device) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p = make_plan(N, D, H, W, Ci, Co, sm_count(device));
  if (workspace_bytes < p.workspace_bytes) return static_cast<int>(cudaErrorInvalidValue);
  const int Kpad = (27 * Ci + BK - 1) / BK * BK;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* wb = static_cast<const bf16*>(w);
  const auto* bb = static_cast<const float*>(bias);
  auto* ob = static_cast<bf16*>(out);
  auto* ws = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.halo) {
    err = p.bn == 64 ? launch_halo<64>(p, xb, wb, bb, ob, ws, N, D, H, W, Ci, Co, Kpad, relu, s)
                     : launch_halo<128>(p, xb, wb, bb, ob, ws, N, D, H, W, Ci, Co, Kpad, relu, s);
  } else {
    err = p.bn == 64 ? launch_gather<64>(xb, wb, bb, ob, N, D, H, W, Ci, Co, Kpad, relu, s)
                     : launch_gather<128>(xb, wb, bb, ob, N, D, H, W, Ci, Co, Kpad, relu, s);
  }
  return static_cast<int>(err);
}

const char* pcmseg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
