// Weight gradient of the 3x3x3 SAME convolution over NDHWC with fp32
// operands: fp32 x and dy, fp32 products and sums, fp32 out, for Hopper
// (sm_90a) on the CUDA cores (FFMA).
//
// Replaces the fp32 path of the Pallas TPU kernel
// pcmseg_tpu/ops/pallas/conv3d_grad.py::conv3x3_dw (pl.pallas_call body
// `_dw_kernel`, "bf16 or fp32" x and dy): dW[tap, ci, co] = sum over every
// voxel v of the batch of x[v + offset(tap), ci] * dy[v, co], neighbours
// outside the volume read as zero. The bf16 path is conv3x3_dw.cu. Exact fp32
// products (FFMA), not TF32: see conv3x3x3_f32.cu.
//
// Formulation: per tap a GEMM with M = Ci, N = Co and K = the N*D*H*W
// voxels. The kernel takes Ci == 8 or a multiple of 64 (the wrapper zero-pads
// x's channels, as for bf16) and Co % 8 == 0.
//
// What bounds it on an H100 (66.9 TFLOP/s fp32 FFMA, 3.35 TB/s): 2*27*Ci*Co
// FLOP per voxel over 4*(Ci + Co) bytes, 432 FLOP per byte at 64 -> 64: the
// FFMA issue rate. Design:
//
//  * a block owns 8 input channels x 64 output channels and all 27 taps; its
//    288 threads are 18 (kd, kh, 4-channel half of the 8) row groups x 16
//    groups of 4 output channels, each holding its 3 kw taps x 4 ci x 4 co;
//  * it walks 2x8x8-voxel tiles of its range of the volume: dy (128 voxels x
//    64 channels) and the x halo (4x10x10 voxels x 8 channels) are copied
//    into a 2-stage shared-memory ring by cp.async, zero-filled outside the
//    volume (the SAME padding), the next tile's copy in flight while this
//    one is summed. The staging keeps NDHWC's channels-innermost layout, so a
//    thread reads its 4 dy channels and each tap's 4 x channels as 16-byte
//    loads (384 FFMA per 32 shared loads of a tile row);
//  * each tile's 128 products are summed into a fresh accumulator that is
//    added to the running total, so a sum runs over one tile and then over
//    the tiles of the block's range: never over 2.1 M sequential terms;
//  * the voxel tiles are split over gridDim.z so that the blocks fill the
//    card; a second pass adds the split partials in split order. No atomics:
//    two launches agree bit for bit.

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int TZ = 2, TY = 8, TX = 8;  // voxel tile
constexpr int HZ = TZ + 2, HY = TY + 2, HX = TX + 2;
constexpr int VOX = TZ * TY * TX;   // 128
constexpr int HVOX = HZ * HY * HX;  // 400
constexpr int CT = 8;               // input channels per block
constexpr int BC = 64;              // output channels per block
constexpr int THREADS = 288;        // 18 row groups x 16 groups of 4 output channels
constexpr int STAGE_FLOATS = VOX * BC + HVOX * CT;
constexpr int STAGES = 2;
constexpr int SMEM = STAGES * STAGE_FLOATS * static_cast<int>(sizeof(float));
constexpr int MIN_TILES_PER_SPLIT = 4;

struct DwF32Args {
  const float* x;
  const float* dy;
  float* dst;  // (27, Ci, Co) fp32, one slab per split
  int D, H, W, Ci, Co;
  int tiles_z, tiles_y, tiles_x, tiles;
  int tiles_per_split;
};

// 16 bytes global -> shared, asynchronously; zeros when `valid` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// Issue the copies of voxel tile `t` into `stage` (dy [voxel][co], x halo
// [halo voxel][ci], both channels innermost as in NDHWC).
__device__ __forceinline__ void load_tile(const DwF32Args& a, float* stage, int t, int ci0, int co0) {
  int r = t;
  const int x0 = (r % a.tiles_x) * TX;
  r /= a.tiles_x;
  const int y0 = (r % a.tiles_y) * TY;
  r /= a.tiles_y;
  const int z0 = (r % a.tiles_z) * TZ;
  const int n = r / a.tiles_z;
  float* dys = stage;
  float* xs = stage + VOX * BC;
  for (int idx = threadIdx.x; idx < VOX * (BC / 4) + HVOX * (CT / 4); idx += THREADS) {
    if (idx < VOX * (BC / 4)) {
      const int q = idx % (BC / 4), v = idx / (BC / 4);
      const int gx = x0 + v % TX, gy = y0 + (v / TX) % TY, gz = z0 + v / (TX * TY);
      const int co = co0 + 4 * q;
      const bool ok = gz < a.D && gy < a.H && gx < a.W && co < a.Co;
      const long long off =
          ok ? (((static_cast<long long>(n) * a.D + gz) * a.H + gy) * a.W + gx) * a.Co + co : 0;
      cp_async16(dys + v * BC + 4 * q, a.dy + off, ok);
    } else {
      const int j = idx - VOX * (BC / 4);
      const int q = j % (CT / 4), hv = j / (CT / 4);
      const int gx = x0 - 1 + hv % HX, gy = y0 - 1 + (hv / HX) % HY, gz = z0 - 1 + hv / (HX * HY);
      const bool ok = gz >= 0 && gz < a.D && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
      const long long off =
          ok ? (((static_cast<long long>(n) * a.D + gz) * a.H + gy) * a.W + gx) * a.Ci + ci0 + 4 * q : 0;
      cp_async16(xs + hv * CT + 4 * q, a.x + off, ok);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) conv3x3_dw_f32_kernel(const DwF32Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int ci0 = blockIdx.x * CT;
  const int co0 = blockIdx.y * BC;
  const int t_begin = blockIdx.z * a.tiles_per_split;
  const int t_end = min(a.tiles, t_begin + a.tiles_per_split);

  const int tid = threadIdx.x;
  const int c4 = tid & 15;  // output channels co0 + 4*c4 .. +3
  const int rg = tid >> 4;  // row group: taps (kd, kh, kw = 0..2), channels ci0 + 4*half .. +3
  const int kd = rg / 6, kh = (rg / 2) % 3, half = rg & 1;

  float total[3][4][4], part[3][4][4];
#pragma unroll
  for (int kw = 0; kw < 3; ++kw)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) total[kw][j][k] = 0.f;

  if (t_begin < t_end) load_tile(a, smem, t_begin, ci0, co0);
  cp_async_commit();
  for (int t = t_begin; t < t_end; ++t) {
    const int s = (t - t_begin) & 1;
    if (t + 1 < t_end) load_tile(a, smem + (s ^ 1) * STAGE_FLOATS, t + 1, ci0, co0);
    cp_async_commit();
    cp_async_wait_one();  // this tile's copies have landed
    __syncthreads();

    const float4* dy4 = reinterpret_cast<const float4*>(smem + s * STAGE_FLOATS) + c4;
    const float4* x4 = reinterpret_cast<const float4*>(smem + s * STAGE_FLOATS + VOX * BC) + half;
#pragma unroll
    for (int kw = 0; kw < 3; ++kw)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) part[kw][j][k] = 0.f;
#pragma unroll 1
    for (int zy = 0; zy < TZ * TY; ++zy) {
      const int z = zy / TY, y = zy % TY;
      const int hrow = ((z + kd) * HY + y + kh) * HX;
#pragma unroll
      for (int x = 0; x < TX; ++x) {
        const float4 d = dy4[(zy * TX + x) * (BC / 4)];
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const float4 xv = x4[(hrow + x + kw) * (CT / 4)];
          const float xj[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            part[kw][j][0] = fmaf(xj[j], d.x, part[kw][j][0]);
            part[kw][j][1] = fmaf(xj[j], d.y, part[kw][j][1]);
            part[kw][j][2] = fmaf(xj[j], d.z, part[kw][j][2]);
            part[kw][j][3] = fmaf(xj[j], d.w, part[kw][j][3]);
          }
        }
      }
    }
#pragma unroll
    for (int kw = 0; kw < 3; ++kw)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) total[kw][j][k] += part[kw][j][k];
    __syncthreads();  // every read of this stage is done before it is refilled
  }

  const int co = co0 + 4 * c4;
  if (co >= a.Co) return;
  float* out = a.dst + static_cast<long long>(blockIdx.z) * 27 * a.Ci * a.Co;
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
    const int tap = (kd * 3 + kh) * 3 + kw;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = ci0 + 4 * half + j;
      *reinterpret_cast<float4*>(out + (static_cast<long long>(tap) * a.Ci + ci) * a.Co + co) =
          make_float4(total[kw][j][0], total[kw][j][1], total[kw][j][2], total[kw][j][3]);
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
  int grid_x, grid_y, splits, tiles_per_split;
  int tiles_z, tiles_y, tiles_x, tiles;
  long long workspace_bytes;
};

DwF32Plan make_dw_f32_plan(int N, int D, int H, int W, int Ci, int Co, int sms) {
  DwF32Plan p{};
  p.tiles_z = (D + TZ - 1) / TZ;
  p.tiles_y = (H + TY - 1) / TY;
  p.tiles_x = (W + TX - 1) / TX;
  p.tiles = N * p.tiles_z * p.tiles_y * p.tiles_x;
  p.grid_x = Ci / CT;
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
  if (!(Ci == 8 || Ci % 64 == 0) || Co % 8) return static_cast<int>(cudaErrorInvalidValue);
  const DwF32Plan p = make_dw_f32_plan(N, D, H, W, Ci, Co, sm_count(device));
  if (workspace_bytes < p.workspace_bytes) return static_cast<int>(cudaErrorInvalidValue);
  err = set_smem(conv3x3_dw_f32_kernel, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);

  DwF32Args a;
  a.x = static_cast<const float*>(x);
  a.dy = static_cast<const float*>(dy);
  a.dst = p.splits > 1 ? static_cast<float*>(workspace) : static_cast<float*>(out);
  a.D = D, a.H = H, a.W = W, a.Ci = Ci, a.Co = Co;
  a.tiles_z = p.tiles_z, a.tiles_y = p.tiles_y, a.tiles_x = p.tiles_x, a.tiles = p.tiles;
  a.tiles_per_split = p.tiles_per_split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  conv3x3_dw_f32_kernel<<<dim3(p.grid_x, p.grid_y, p.splits), THREADS, SMEM, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
  const long long count4 = 27LL * Ci * Co / 4;
  const unsigned blocks = static_cast<unsigned>(std::min<long long>((count4 + 255) / 256, 65535));
  dw_reduce_f32<<<blocks, 256, 0, s>>>(reinterpret_cast<const float4*>(workspace), static_cast<float4*>(out),
                                       count4, p.splits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
