// Fused 3x3x3 SAME convolution + bias + optional ReLU over NDHWC, bf16 in and
// out, fp32 accumulation, for Hopper (sm_90a): warpgroup wgmma fed by TMA.
//
// Replaces the Pallas TPU kernel pcmseg_tpu/ops/pallas/conv3d.py::conv3x3x3
// (pl.pallas_call body `_kernel`). Same arithmetic: out = max(sum over the 27
// taps of window . W_tap + b, 0), accumulated in fp32, bias added in fp32, then
// ReLU, then one rounding to bf16. With relu off, no bias and the flipped,
// Ci<->Co-transposed weight it is also the convolution's dx.
//
// Formulation: implicit GEMM, M = output voxels, N = Co, K = 27*Ci with
// k = tap*Ci + ci and tap = (kd*3 + kh)*3 + kw. The weight is packed once per
// load as a (Co, 27*Ci) row-major bf16 matrix. The kernel takes Ci == 8 or a
// multiple of 64 (the wrapper zero-pads x's channels, e.g. the Ci = 5 input
// conv to 8) and Co % 8 == 0.
//
// What bounds it on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): with x read
// once and y written once a layer does 27*Ci*Co/(Ci+Co) FLOP per byte, 864
// for 64->64, far above the ~295 ridge; only the Ci = 8 input conv is bound
// by its bytes. So the design is about feeding the tensor cores:
//
//  * a block owns a BN-wide slice of Co (BN = 128, or 64 when Co is not a
//    multiple of 128) over a (2*MZ)x8x8 (z, y, x) tile of output voxels.
//    Two consumer warpgroups each run wgmma.mma_async m64nBNk16 over MZ
//    z-planes (64 voxels = 8 rows of 8 x each) with fp32 accumulators in
//    registers. MZ = 2 at BN = 64, where one m64n64k16 is too little work
//    per pipeline stage and per halo load; MZ = 1 at BN = 128;
//  * A, the activations, is read by the tensor cores straight from shared
//    memory. For each 64-channel chunk one producer thread loads the tile's
//    (2*MZ+2)x10x10 x halo by TMA as eight 5-D boxes of 8 channels (16-byte
//    rows, no swizzle): slab g holds channels 8g..8g+7 of every halo voxel.
//    That is wgmma's no-swizzle K-major layout: a core matrix is 8 halo
//    voxels adjacent in x, 8-row groups (y rows) lie HX*16 bytes apart, the
//    two 8-channel halves of a k16 step one slab apart. A tap is therefore
//    just a start address; x is fetched once per chunk for all 27 taps, and
//    TMA's zero fill of out-of-volume coordinates is the SAME padding;
//  * B, the weight, streams through a ring of 64-column tiles (one tap of
//    one chunk), loaded by TMA with the 128-byte swizzle that wgmma reads
//    conflict-free; full/empty mbarriers pair the producer with the
//    consumers, and a consumer releases a stage as soon as the wgmma group
//    that read it has completed, keeping one group in flight;
//  * Ci = 8 (the padded input conv): one 8-channel slab, K = 216 as four
//    64-column weight tiles; a k16 step covers two taps, the second tap's
//    8 channels one halo offset away (the descriptor's LBO);
//  * layers whose tiles alone cannot fill the card (16^3, 8^3) split the
//    channel chunks over gridDim.z into an fp32 workspace and a second pass
//    adds the partials in a fixed order, then bias and ReLU: deterministic.
//
// Two blocks share an SM (100-110 KB of shared memory each), so one
// block's halo load and epilogue overlap the other's wgmma.

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int TY = 8, TX = 8;  // output tile rows; z extent 2 * MZ
constexpr int HY = TY + 2, HX = TX + 2;
constexpr int CHUNK = 64;     // channels per halo load
constexpr int THREADS = 288;  // 2 consumer warpgroups + 1 producer warp

template <int BN>
struct Cfg {
  static constexpr int MZ = BN == 64 ? 2 : 1;  // z-planes per warpgroup
  static constexpr int TZ = 2 * MZ, HZ = TZ + 2;
  static constexpr int SLAB = HZ * HY * HX * 16;  // one 8-channel slab of the halo
  static constexpr int STAGES = BN == 64 ? 4 : 3;
  static constexpr int B_BYTES = BN * 128;  // a 64-column weight tile
  static constexpr int HALO_OFF = STAGES * B_BYTES;
  static constexpr int BAR_OFF = HALO_OFF + 8 * SLAB;
  static constexpr int SMEM = BAR_OFF + 8 * (2 * STAGES + 2) + 1024;  // + alignment slack
};

struct FwdArgs {
  const float* bias;
  bf16* out;
  float* workspace;  // split-K partials, or null
  int D, H, W, Ci, Co, relu;
  int tiles_z, tiles_y, tiles_x;
  int chunks_per_split;
  long long M;  // N*D*H*W
};

// Halo row of output voxel (z-plane z, y 0, x 0) of the tile for tap `tap`.
__device__ __forceinline__ int halo_row(int z, int tap) {
  return ((z + tap / 9) * HY + (tap / 3) % 3) * HX + tap % 3;
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

template <int BN>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 64)
    wgmma_m64n64k16<0, 0>(d, da, db);
  else
    wgmma_m64n128k16<0, 0>(d, da, db);
}

// SMALL: Ci == 8 (one slab, two taps per k16 step); else Ci % 64 == 0.
template <int BN, bool SMALL>
__global__ void __launch_bounds__(THREADS, 2)
    conv3x3x3_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                     const FwdArgs a) {
  using C = Cfg<BN>;
  constexpr int MZ = C::MZ, SLAB = C::SLAB;
  constexpr int SLABS = SMALL ? 1 : CHUNK / 8;
  constexpr int STEPS = SMALL ? 4 : 27;  // weight tiles per chunk

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzled tiles want 1024
  const uint32_t b_smem = base, halo_smem = base + C::HALO_OFF, bar = base + C::BAR_OFF;
  const uint32_t halo_full = bar + 16 * C::STAGES, halo_empty = halo_full + 8;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (C::STAGES + s); };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    mbar_init(halo_full, 1);
    mbar_init(halo_empty, 2);
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
      int s = 0;
      uint32_t ph = 0, hph = 0;
      for (int c = c_begin; c < c_end; ++c) {
        mbar_wait(halo_empty, hph ^ 1);
        hph ^= 1;
        mbar_expect_tx(halo_full, SLABS * SLAB);
        for (int g = 0; g < SLABS; ++g)
          tma_load_5d(halo_smem + g * SLAB, &xmap, halo_full, c * CHUNK + 8 * g, x0 - 1, y0 - 1, z0 - 1, n);
        for (int st = 0; st < STEPS; ++st) {
          mbar_wait(empty(s), ph ^ 1);
          mbar_expect_tx(full(s), C::B_BYTES);
          tma_load_2d(b_smem + s * C::B_BYTES, &wmap, full(s), SMALL ? st * 64 : st * a.Ci + c * CHUNK, n0);
          if (++s == C::STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg computes z-planes wg * MZ + m of the tile
  const int wg = tid >> 7;
  float acc[MZ][BN / 2];
#pragma unroll
  for (int m = 0; m < MZ; ++m) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[m][i] = 0.f;
    fence_regs(acc[m]);
  }

  int s = 0, prev = -1;
  uint32_t ph = 0, hph = 0;
  for (int c = c_begin; c < c_end; ++c) {
    mbar_wait(halo_full, hph);
    hph ^= 1;
    for (int st = 0; st < STEPS; ++st) {
      mbar_wait(full(s), ph);
      wgmma_fence();
      const uint32_t bs = b_smem + s * C::B_BYTES;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint64_t db = gmma_desc(bs + 32 * j, 16, 1024, LAYOUT_B128);
#pragma unroll
        for (int m = 0; m < MZ; ++m) {
          const int z = wg * MZ + m;
          uint32_t a_addr, lbo;
          if constexpr (SMALL) {
            // taps t0 and t0 + 1. The weight's K past 216 reads as zero, so
            // a tap past 26 re-reads tap 26's (finite) channels: no branch
            // around the wgmma, which would serialize the warpgroup's issue
            const int t0 = min(st * 8 + 2 * j, 26);
            const int r0 = halo_row(z, t0);
            a_addr = halo_smem + r0 * 16;
            lbo = t0 + 1 < 27 ? (halo_row(z, t0 + 1) - r0) * 16 : 0;
          } else {
            a_addr = halo_smem + halo_row(z, st) * 16 + 2 * j * SLAB;
            lbo = SLAB;
          }
          wgmma_bn<BN>(acc[m], gmma_desc(a_addr, lbo, HX * 16, LAYOUT_INTERLEAVE), db);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's group is done reading its tiles
      if (prev >= 0 && (tid & 127) == 0) mbar_arrive(empty(prev));
      prev = s;
      if (++s == C::STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();  // every read of this chunk's halo is done
    if ((tid & 127) == 0) {
      mbar_arrive(empty(prev));
      mbar_arrive(halo_empty);
    }
    prev = -1;
  }
#pragma unroll
  for (int m = 0; m < MZ; ++m) fence_regs(acc[m]);

  float* partial = a.workspace ? a.workspace + blockIdx.z * a.M * a.Co : nullptr;
  const int lane = tid & 31, warp = (tid >> 5) & 3;
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
        if (col < a.Co)
          store_pair(acc[m][4 * j + 2 * h], acc[m][4 * j + 2 * h + 1], v, col, a.Co, a.bias, a.relu, a.out,
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

// ---- launch plan -------------------------------------------------------------

struct Plan {
  bool small;
  int bn;
  int tiles_z, tiles_y, tiles_x;
  int splits, chunks_per_split;
  long long workspace_bytes;
};

Plan make_plan(int N, int D, int H, int W, int Ci, int Co, int sms) {
  Plan p{};
  p.small = Ci == 8;
  p.bn = Co % 128 == 0 ? 128 : 64;
  const int tz = p.bn == 64 ? Cfg<64>::TZ : Cfg<128>::TZ;
  p.tiles_z = (D + tz - 1) / tz;
  p.tiles_y = (H + TY - 1) / TY;
  p.tiles_x = (W + TX - 1) / TX;
  const int chunks = p.small ? 1 : Ci / CHUNK;
  const long long blocks =
      static_cast<long long>(N) * p.tiles_z * p.tiles_y * p.tiles_x * ((Co + p.bn - 1) / p.bn);
  // fewer blocks than two waves (two blocks per SM): split K over the chunks
  const long long want = 4LL * sms;
  p.splits = blocks < want ? static_cast<int>(std::min<long long>(chunks, (want + blocks - 1) / blocks)) : 1;
  p.chunks_per_split = (chunks + p.splits - 1) / p.splits;
  p.splits = (chunks + p.chunks_per_split - 1) / p.chunks_per_split;
  if (p.splits > 1)
    p.workspace_bytes = static_cast<long long>(p.splits) * N * D * H * W * Co * sizeof(float);
  return p;
}

template <int BN, bool SMALL>
cudaError_t launch(const Plan& p, const CUtensorMap& xmap, const CUtensorMap& wmap, const FwdArgs& a, int N,
                   cudaStream_t stream) {
  auto kernel = conv3x3x3_kernel<BN, SMALL>;
  cudaError_t err = set_smem(kernel, Cfg<BN>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(N) * p.tiles_z * p.tiles_y * p.tiles_x),
                  static_cast<unsigned>((a.Co + BN - 1) / BN), static_cast<unsigned>(p.splits));
  kernel<<<grid, THREADS, Cfg<BN>::SMEM, stream>>>(xmap, wmap, a);
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
// checks shapes, dtypes, contiguity and 16-byte alignment, requires Ci == 8
// or Ci % 64 == 0 and Co % 8 == 0, passes the (Co, 27*Ci) packed weight and
// a workspace of at least pcmseg_conv3x3x3_workspace_bytes(...) bytes.
// Returns the cudaError_t of the launch; does not synchronise.
int pcmseg_conv3x3x3_bf16(const void* x, const void* w, const void* bias, void* out, void* workspace,
                          long long workspace_bytes, int N, int D, int H, int W, int Ci, int Co, int relu,
                          void* stream, int device) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!(Ci == 8 || Ci % CHUNK == 0) || Co % 8) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(N, D, H, W, Ci, Co, sm_count(device));
  if (workspace_bytes < p.workspace_bytes) return static_cast<int>(cudaErrorInvalidValue);

  CUtensorMap xmap, wmap;
  err = make_ndhwc_map(&xmap, x, N, D, H, W, Ci, 8, HX, HY, p.bn == 64 ? Cfg<64>::HZ : Cfg<128>::HZ, false);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(27) * Ci, static_cast<cuuint64_t>(Co)};
  const cuuint64_t wstride[1] = {static_cast<cuuint64_t>(27) * Ci * sizeof(bf16)};
  const cuuint32_t wbox[2] = {64, static_cast<cuuint32_t>(p.bn)};
  err = make_tensor_map(&wmap, w, 2, wdims, wstride, wbox, true);
  if (err != cudaSuccess) return static_cast<int>(err);

  FwdArgs a;
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<bf16*>(out);
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
  splitk_epilogue<<<blocks, 256, 0, s>>>(static_cast<const float*>(workspace), a.bias, a.out, a.M, Co,
                                         p.splits, relu);
  return static_cast<int>(cudaGetLastError());
}

const char* pcmseg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
