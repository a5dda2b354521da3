// Fused 3x3x3 SAME convolution + bias + optional ReLU over NDHWC with fp32
// operands: fp32 x, weight, bias and output, fp32 products and sums, for
// Hopper (sm_90a) on the CUDA cores (FFMA).
//
// Replaces the fp32 path of the Pallas TPU kernel
// pcmseg_tpu/ops/pallas/conv3d.py::conv3x3x3 (pl.pallas_call body `_kernel`,
// which computes in x's dtype): out = max(sum over the 27 taps of window . W_tap
// + b, 0). With relu off, no bias and the flipped, Ci<->Co-transposed weight
// it is also the convolution's dx. The bf16 path is conv3x3x3.cu.
//
// Why FFMA and not the tensor cores: the Pallas kernel in interpret mode and
// XLA's CPU conv take exact fp32 products. A single TF32 wgmma keeps 10
// mantissa bits of each operand (~5e-4 relative error), so it does not
// compute the same function; 3xTF32 would, and is later work.
//
// Formulation: implicit GEMM, M = output voxels, N = Co, K = 27*Ci, with the
// bf16 kernel's packed weight layout, (Co, 27*Ci) row-major, k = tap*Ci + ci,
// tap = (kd*3 + kh)*3 + kw. The kernel takes Ci == 8 or a multiple of 64 (the
// wrapper zero-pads x's channels, as for bf16) and Co % 8 == 0.
//
// What bounds it on an H100 (66.9 TFLOP/s fp32 FFMA, 3.35 TB/s): a layer does
// 27*Ci*Co/(Ci+Co)/2 FLOP per byte of fp32 x and y, 432 at 64->64, far above
// the FFMA ridge of ~20 FLOP/byte: the FFMA issue rate bounds it. Design:
//
//  * a block owns a 2x8x8 (z, y, x) tile of output voxels and 64 output
//    channels; its 256 threads each hold 8 voxels (one x row) x 4 channels of
//    fp32 accumulators in registers;
//  * the K loop walks 8-channel chunks: the tile's 4x10x10 x halo for the
//    chunk (zeros outside the volume: the SAME padding) and the chunk's
//    27 x 8 x 64 weight slice are staged in shared memory, transposed to
//    [ci][voxel] and [tap][ci][co] so that a thread reads one x row of 10
//    values per (ci, kd, kh) for all three kw taps, and its 4 weights of a tap
//    as one 16-byte load (96 FFMA per 13 shared loads);
//  * each chunk's 216 products are summed into a fresh accumulator that is
//    then added to the running total, so no sum runs over more than 216 terms
//    plus the chunk count;
//  * layers whose tiles alone cannot fill the card (16^3, 8^3) split the
//    chunks over gridDim.z into an fp32 workspace, and a second pass adds the
//    partials in a fixed order, then bias and ReLU. No atomics: two launches
//    agree bit for bit.

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int TZ = 2, TY = 8, TX = 8;  // output tile
constexpr int HZ = TZ + 2, HY = TY + 2, HX = TX + 2;
constexpr int HVOX = HZ * HY * HX;  // 400 halo voxels
constexpr int CK = 8;               // input channels per chunk
constexpr int BN = 64;              // output channels per block
constexpr int THREADS = 256;        // 16 (z, y) rows x 16 groups of 4 output channels
constexpr int W_FLOATS = 27 * CK * BN;
constexpr int X_FLOATS = CK * HVOX;
constexpr int SMEM = (W_FLOATS + X_FLOATS) * static_cast<int>(sizeof(float));

struct F32Args {
  const float* x;
  const float* w;
  const float* bias;
  float* out;
  float* workspace;  // split-K partials, or null
  int D, H, W, Ci, Co, relu;
  int tiles_z, tiles_y, tiles_x;
  int chunks_per_split;
  long long M;  // N*D*H*W
};

__device__ __forceinline__ float4 epilogue(float4 v, const float* bias, int co, int relu) {
  if (bias) {
    v.x += bias[co];
    v.y += bias[co + 1];
    v.z += bias[co + 2];
    v.w += bias[co + 3];
  }
  if (relu) {
    v.x = fmaxf(v.x, 0.f);
    v.y = fmaxf(v.y, 0.f);
    v.z = fmaxf(v.z, 0.f);
    v.w = fmaxf(v.w, 0.f);
  }
  return v;
}

__global__ void __launch_bounds__(THREADS, 2) conv3x3x3_f32_kernel(const F32Args a) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [tap][ci][co]
  float* xs = ws + W_FLOATS;                    // [ci][hz][hy][hx]

  int t = blockIdx.x;
  const int x0 = (t % a.tiles_x) * TX;
  t /= a.tiles_x;
  const int y0 = (t % a.tiles_y) * TY;
  t /= a.tiles_y;
  const int z0 = (t % a.tiles_z) * TZ;
  const int n = t / a.tiles_z;
  const int co0 = blockIdx.y * BN;
  const int chunks = a.Ci / CK;
  const int c_begin = blockIdx.z * a.chunks_per_split;
  const int c_end = min(chunks, c_begin + a.chunks_per_split);

  const int tid = threadIdx.x;
  const int c4 = tid & 15;  // output channels co0 + 4*c4 .. +3
  const int row = tid >> 4;  // (z, y) = (row / TY, row % TY) of the tile
  const int rz = row / TY, ry = row % TY;
  const long long K = 27LL * a.Ci;

  float total[TX][4], acc[TX][4];
#pragma unroll
  for (int i = 0; i < TX; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) total[i][j] = 0.f;

  for (int c = c_begin; c < c_end; ++c) {
    // stage the chunk's weight slice: thread pairs read one (co, tap)'s 8
    // channels (32 contiguous bytes) and scatter them to [tap][ci][co]
    for (int idx = tid; idx < 27 * 2 * BN; idx += THREADS) {
      const int half = idx & 1, co = (idx >> 1) % BN, tap = idx / (2 * BN);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (co0 + co < a.Co)
        v = *reinterpret_cast<const float4*>(a.w + (co0 + co) * K + tap * a.Ci + c * CK + half * 4);
      float* dst = ws + (tap * CK + half * 4) * BN + co;
      dst[0] = v.x;
      dst[BN] = v.y;
      dst[2 * BN] = v.z;
      dst[3 * BN] = v.w;
    }
    // stage the chunk's x halo, zeros outside the volume
    for (int idx = tid; idx < 2 * HVOX; idx += THREADS) {
      const int half = idx & 1, hv = idx >> 1;
      const int gx = x0 - 1 + hv % HX, gy = y0 - 1 + (hv / HX) % HY, gz = z0 - 1 + hv / (HX * HY);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gz >= 0 && gz < a.D && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W)
        v = *reinterpret_cast<const float4*>(
            a.x + (((static_cast<long long>(n) * a.D + gz) * a.H + gy) * a.W + gx) * a.Ci + c * CK + half * 4);
      float* dst = xs + (half * 4) * HVOX + hv;
      dst[0] = v.x;
      dst[HVOX] = v.y;
      dst[2 * HVOX] = v.z;
      dst[3 * HVOX] = v.w;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < TX; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    const float4* w4 = reinterpret_cast<const float4*>(ws) + c4;
#pragma unroll 1
    for (int ci = 0; ci < CK; ++ci) {
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const float* xr = xs + ci * HVOX + ((rz + kd) * HY + ry + kh) * HX;
          float xv[HX];
#pragma unroll
          for (int i = 0; i < HX; ++i) xv[i] = xr[i];
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            const float4 wv = w4[((((kd * 3 + kh) * 3 + kw) * CK) + ci) * (BN / 4)];
#pragma unroll
            for (int i = 0; i < TX; ++i) {
              acc[i][0] = fmaf(xv[i + kw], wv.x, acc[i][0]);
              acc[i][1] = fmaf(xv[i + kw], wv.y, acc[i][1]);
              acc[i][2] = fmaf(xv[i + kw], wv.z, acc[i][2]);
              acc[i][3] = fmaf(xv[i + kw], wv.w, acc[i][3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TX; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) total[i][j] += acc[i][j];
    __syncthreads();  // every read of this chunk's tiles is done
  }

  const int z = z0 + rz, y = y0 + ry, co = co0 + 4 * c4;
  if (z >= a.D || y >= a.H || co >= a.Co) return;
  float* partial = a.workspace ? a.workspace + blockIdx.z * a.M * a.Co : nullptr;
#pragma unroll
  for (int i = 0; i < TX; ++i) {
    const int x = x0 + i;
    if (x >= a.W) break;
    const long long v = ((static_cast<long long>(n) * a.D + z) * a.H + y) * a.W + x;
    float4 r = make_float4(total[i][0], total[i][1], total[i][2], total[i][3]);
    if (partial)
      *reinterpret_cast<float4*>(partial + v * a.Co + co) = r;
    else
      *reinterpret_cast<float4*>(a.out + v * a.Co + co) = epilogue(r, a.bias, co, a.relu);
  }
}

// Sum the split-K partials in a fixed order, then bias, ReLU.
__global__ void splitk_epilogue_f32(const float4* __restrict__ workspace, const float* __restrict__ bias,
                                    float4* __restrict__ out, long long M, int Co, int splits, int relu) {
  const long long count4 = M * Co / 4;
  for (long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; p < count4;
       p += static_cast<long long>(gridDim.x) * blockDim.x) {
    float4 s = workspace[p];
    for (int k = 1; k < splits; ++k) {
      const float4 v = workspace[k * count4 + p];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out[p] = epilogue(s, bias, static_cast<int>((4 * p) % Co), relu);
  }
}

struct F32Plan {
  int tiles_z, tiles_y, tiles_x;
  int splits, chunks_per_split;
  long long blocks, workspace_bytes;
};

F32Plan make_f32_plan(int N, int D, int H, int W, int Ci, int Co, int sms) {
  F32Plan p{};
  p.tiles_z = (D + TZ - 1) / TZ;
  p.tiles_y = (H + TY - 1) / TY;
  p.tiles_x = (W + TX - 1) / TX;
  const int chunks = Ci / CK;
  p.blocks = static_cast<long long>(N) * p.tiles_z * p.tiles_y * p.tiles_x * ((Co + BN - 1) / BN);
  // fewer blocks than two waves (two blocks per SM): split K over the chunks
  const long long want = 4LL * sms;
  p.splits = p.blocks < want ? static_cast<int>(std::min<long long>(chunks, (want + p.blocks - 1) / p.blocks)) : 1;
  p.chunks_per_split = (chunks + p.splits - 1) / p.splits;
  p.splits = (chunks + p.chunks_per_split - 1) / p.chunks_per_split;
  if (p.splits > 1)
    p.workspace_bytes = static_cast<long long>(p.splits) * N * D * H * W * Co * sizeof(float);
  return p;
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
// or Ci % 64 == 0 and Co % 8 == 0, passes the (Co, 27*Ci) packed fp32 weight
// and a workspace of at least pcmseg_conv3x3x3_f32_workspace_bytes(...)
// bytes. Returns the cudaError_t of the launches; does not synchronise.
int pcmseg_conv3x3x3_f32(const void* x, const void* w, const void* bias, void* out, void* workspace,
                         long long workspace_bytes, int N, int D, int H, int W, int Ci, int Co, int relu,
                         void* stream, int device) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!(Ci == 8 || Ci % 64 == 0) || Co % 8) return static_cast<int>(cudaErrorInvalidValue);
  const F32Plan p = make_f32_plan(N, D, H, W, Ci, Co, sm_count(device));
  if (workspace_bytes < p.workspace_bytes || p.blocks / ((Co + BN - 1) / BN) > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  err = set_smem(conv3x3x3_f32_kernel, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);

  F32Args a;
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.workspace = p.splits > 1 ? static_cast<float*>(workspace) : nullptr;
  a.D = D, a.H = H, a.W = W, a.Ci = Ci, a.Co = Co, a.relu = relu;
  a.tiles_z = p.tiles_z, a.tiles_y = p.tiles_y, a.tiles_x = p.tiles_x;
  a.chunks_per_split = p.chunks_per_split;
  a.M = static_cast<long long>(N) * D * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(N) * p.tiles_z * p.tiles_y * p.tiles_x),
                  static_cast<unsigned>((Co + BN - 1) / BN), static_cast<unsigned>(p.splits));
  conv3x3x3_f32_kernel<<<grid, THREADS, SMEM, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
  const long long count4 = a.M * Co / 4;
  const unsigned blocks = static_cast<unsigned>(std::min<long long>((count4 + 255) / 256, 65535));
  splitk_epilogue_f32<<<blocks, 256, 0, s>>>(reinterpret_cast<const float4*>(workspace), a.bias,
                                             static_cast<float4*>(out), a.M, Co, p.splits, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
