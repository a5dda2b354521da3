// BatchNorm over the batch, with the ReLU that follows it, in training, over
// NDHWC viewed as (M voxels, C channels): bf16, fp16 or fp32 (one template,
// an entry code a type), for Hopper (sm_90a). Four launches a layer:
//
//   1. batchnorm_stats_kernel      Σx and Σx² per channel;
//   2. batchnorm_relu_kernel       the per-channel finish in its prologue,
//                                  y = max(x·mult + shift, 0), the running
//                                  statistics moved;
//   3. batchnorm_grad_sums_kernel  Σdy' and Σdy'·(x − mean) per channel,
//                                  dγ and dβ;
//   4. batchnorm_dx_kernel         dx.
//
// The wrapper (ops/kernels/batchnorm.py) all-reduces the fp32 sums of 1 and
// of 3 over the ranks of a synchronised batch before 2 and 4.
//
// Replaces no Pallas kernel: the JAX package leaves BatchNorm and ReLU to
// XLA, which fuses them into its neighbours (its Pallas fused_norm_relu.py
// was deleted unused, BENCH.md:308-317). PyTorch has no such fusion: the
// plain version is ~30 ops a layer, ~122 bytes moved an element.
//
// Arithmetic (the plain version's, models/norm.py:58-66 in JAX):
//   mean = Σx/n, var = max(Σx²/n − mean², 0), r = (var + eps)^-½,
//   mult = γ·r, shift = β − mean·mult;        y = max(x·mult + shift, 0)
//   dy' = dy where y > 0, else 0 (nn.ReLU's mask, read on y as rounded);
//   dvar = −½·r³·γ·Σdy'(x − mean);
//   dx = dy'·mult + (x − mean)·(2·dvar/n) − mult·Σdy'/n;
//   dγ = r·Σdy'(x − mean), dβ = Σdy' (this rank's sums).
// Every element is read as fp32 and each output rounded once to the element
// type (x·mult + shift and dx as FMAs). Each thread sums its rows in fp32
// over kUnroll rows, then in double; blocks and the last block of a channel
// slice add in double, in a fixed order (no float atomics: two runs give the
// same bits), and a sum is rounded to fp32 once. The per-channel finish runs
// in double and rounds each of mean, var, r, mult, shift to fp32 once. The
// running statistics move as the plain momentum_update moves them, in fp32
// products and a sum (no FMA), so they are the plain formula's bits of the
// same mean and var. The mask is recomputed in 3 and 4 from x with the
// forward's mult and shift: the same FMA and rounding, so the same bits as
// y > 0, and y is not read again.
//
// What bounds it on an H100 (3.35 TB/s): bytes. A few FLOP an element
// against ~295 FLOP a byte at the ridge. An element is read once by 1,
// read and written by 2 (6 bytes forward in bf16), read with its dy by 3,
// and read with its dy and dx written by 4 (10 bytes backward): 16 bytes an
// element in bf16 (32 in fp32), against ~122 for the plain version, which
// copies x and dy to fp32 and makes a pass for each op. Design for that:
//
//  * a thread holds one 16-byte vector of channels (8 bf16 / fp16, 4 fp32)
//    for the whole launch: a block owns a slice of kSliceVectors vectors
//    (128 bytes of each row) and kBlock / width rows at a time, so a warp
//    reads whole 128-byte lines, and each thread computes its own channels'
//    mult and shift (or dx's coefficients) once, in registers;
//  * kUnroll 16-byte loads in flight a thread; the stats and sums passes
//    launch about kStatsBlocksPerSM blocks an SM, the elementwise passes
//    more, each block striding over row tiles of the whole volume;
//  * the cross-block sum needs no extra launch: each block writes its
//    double partials to a scratch buffer, and the last block of each slice
//    to finish (a counter a slice, integer atomics, reset by that block)
//    adds them in block order.

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int kBlock = 256;         // threads a block
constexpr int kSliceVectors = 8;    // 16-byte vectors of a block's channel slice (128 bytes a row)
constexpr int kUnroll = 4;          // 16-byte loads in flight a thread
constexpr int kStatsBlocksPerSM = 2;
constexpr int kApplyBlocksPerSM = 8;
constexpr int kMaxSlices = 1024;    // counters at the scratch's start
constexpr int kCounterBytes = kMaxSlices * 4;

// the rows of the per-channel table (8 x C fp32) that pass 2 writes; rows 6
// and 7 hold pass 1's sums, handed to it as `sums`
enum Row { kMean = 0, kVar, kUnbiased, kRstd, kMult, kShift };

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 v) { return __bfloat162float(v); }
template <>
__device__ __forceinline__ float to_f32<f16>(f16 v) { return __half2float(v); }
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ f16 from_f32<f16>(float v) { return __float2half_rn(v); }
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

// A thread's place in its block: its slice's width in vectors, the rows the
// block covers at once, the thread's vector and row in them, and the first
// of its channels.
struct Lane {
  int width, rows, col, row, c0;
  bool active;
};

template <typename T>
__device__ __forceinline__ Lane lane(int C) {
  constexpr int V = 16 / sizeof(T);
  Lane l;
  const int cols = C / V;
  l.width = min(kSliceVectors, cols - static_cast<int>(blockIdx.y) * kSliceVectors);
  l.rows = kBlock / l.width;
  l.col = threadIdx.x % l.width;
  l.row = threadIdx.x / l.width;
  l.active = l.row < l.rows;
  l.c0 = (blockIdx.y * kSliceVectors + l.col) * V;
  return l;
}

__device__ __forceinline__ uint4 load16(const void* p) { return __ldg(static_cast<const uint4*>(p)); }

// y = x·mult + shift rounded once, and ReLU's keep bit read on y as rounded
// (NaN kept, as nn.ReLU keeps it).
template <typename T>
__device__ __forceinline__ T affine(float x, float mult, float shift, bool relu, bool* keep) {
  const T y = from_f32<T>(__fmaf_rn(x, mult, shift));
  *keep = !(relu && to_f32<T>(y) <= 0.f);
  return *keep ? y : from_f32<T>(0.f);
}

// The block's per-thread double sums (a1, a2: V channels each) to one
// double partial a (stat, channel) of the slice, written to `partial`; the
// last block of the slice to finish adds every block's partials in block
// order and returns true with `total` set for threads t < 2·width·V
// (element t: stat t / (width·V), channel c_of(t)). Other blocks return
// false.
template <int V>
__device__ bool block_sums(const double* a1, const double* a2, const Lane& l, double* partial,
                           unsigned* counters, double* total) {
  constexpr int kPer = 2 * kSliceVectors * V;  // a block's partials, padded to a whole slice
  constexpr int kGroups = kBlock / kPer;
  static_assert(kBlock % kPer == 0, "a block's partials tile the block");
  __shared__ double red[kBlock * 2 * V];
  __shared__ bool last;
  const int t = threadIdx.x, elems = 2 * l.width * V;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    red[t * 2 * V + i] = a1[i];
    red[t * 2 * V + V + i] = a2[i];
  }
  __syncthreads();
  double* mine = partial + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * kPer;
  if (t < elems) {
    const int s = t / (l.width * V), k = t % (l.width * V), col = k / V, i = k % V;
    double sum = 0.0;
    for (int r = 0; r < l.rows; ++r) sum += red[(r * l.width + col) * 2 * V + s * V + i];
    mine[t] = sum;
  }
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(&counters[blockIdx.y], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return false;
  // every block's partial of element e, in block order: kGroups threads an
  // element take every kGroups-th block, then add their sums in order
  const int e = t % kPer, g = t / kPer;
  double sum = 0.0;
  if (e < elems) {
    const double* slice = partial + static_cast<size_t>(blockIdx.y) * gridDim.x * kPer + e;
    for (unsigned b0 = g; b0 < gridDim.x; b0 += kUnroll * 2 * kGroups) {
      double v[kUnroll * 2];  // loads in flight before the adds, which keep block order
#pragma unroll
      for (int k = 0; k < kUnroll * 2; ++k) {
        const unsigned b = b0 + k * kGroups;
        v[k] = b < gridDim.x ? __ldcg(slice + static_cast<size_t>(b) * kPer) : 0.0;
      }
#pragma unroll
      for (int k = 0; k < kUnroll * 2; ++k) sum += v[k];
    }
  }
  __syncthreads();
  red[t] = sum;
  __syncthreads();
  if (t < elems) {
    double s = 0.0;
    for (int j = 0; j < kGroups; ++j) s += red[j * kPer + t];
    *total = s;
  }
  if (t == 0) counters[blockIdx.y] = 0u;
  return true;
}

// channel of element t of a slice's sums
__device__ __forceinline__ int sum_channel(int t, int width, int V) {
  return blockIdx.y * kSliceVectors * V + t % (width * V);
}

// 1. Σx, Σx² per channel into sums (2 x C).
template <typename T>
__global__ void __launch_bounds__(kBlock) batchnorm_stats_kernel(const T* __restrict__ x, long long M, int C,
                                                                  double* partial, unsigned* counters,
                                                                  float* __restrict__ sums) {
  constexpr int V = 16 / sizeof(T);
  const Lane l = lane<T>(C);
  double a1[V], a2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) a1[i] = a2[i] = 0.0;
  if (l.active) {
    const long long tile = static_cast<long long>(l.rows) * kUnroll;
    for (long long base = blockIdx.x * tile + l.row; base < M; base += gridDim.x * tile) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long r = base + static_cast<long long>(u) * l.rows;
        raw[u] = r < M ? load16(x + r * C + l.c0) : make_uint4(0, 0, 0, 0);
      }
      float f1[V], f2[V];
#pragma unroll
      for (int i = 0; i < V; ++i) f1[i] = f2[i] = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const T* e = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float v = to_f32<T>(e[i]);
          f1[i] += v;
          f2[i] = __fmaf_rn(v, v, f2[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        a1[i] += f1[i];
        a2[i] += f2[i];
      }
    }
  }
  double total;
  if (!block_sums<V>(a1, a2, l, partial, counters, &total)) return;
  const int t = threadIdx.x;
  if (t < 2 * l.width * V) sums[(t / (l.width * V)) * C + sum_channel(t, l.width, V)] = static_cast<float>(total);
}

// 2. The per-channel finish from sums (2 x C, all-reduced where the batch is
// synchronised) and y = max(x·mult + shift, 0). Block (0, y)'s first row of
// threads writes the table's mean .. shift rows and, where running_mean is
// given, moves the running statistics (and block (0, 0) counts the batch).
template <typename T>
__global__ void __launch_bounds__(kBlock) batchnorm_relu_kernel(
    const T* __restrict__ x, T* __restrict__ y, long long M, int C, const float* __restrict__ sums,
    const float* __restrict__ gamma, const float* __restrict__ beta, double n, double eps, int relu,
    float* __restrict__ table, float* running_mean, float* running_var, long long* batches, float keep,
    float momentum, float unbias) {
  constexpr int V = 16 / sizeof(T);
  const Lane l = lane<T>(C);
  if (!l.active) return;
  float mult[V], shift[V];
  const bool writer = blockIdx.x == 0 && l.row == 0;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = l.c0 + i;
    const double mean = static_cast<double>(sums[c]) / n;
    const double var = fmax(static_cast<double>(sums[C + c]) / n - mean * mean, 0.0);
    const double r = 1.0 / sqrt(var + eps);
    const double m = static_cast<double>(gamma[c]) * r;
    mult[i] = static_cast<float>(m);
    shift[i] = static_cast<float>(static_cast<double>(beta[c]) - mean * m);
    if (writer) {
      const float mean32 = static_cast<float>(mean), var32 = static_cast<float>(var);
      const float unbiased = __fmul_rn(var32, unbias);
      table[kMean * C + c] = mean32;
      table[kVar * C + c] = var32;
      table[kUnbiased * C + c] = unbiased;
      table[kRstd * C + c] = static_cast<float>(r);
      table[kMult * C + c] = mult[i];
      table[kShift * C + c] = shift[i];
      if (running_mean != nullptr) {
        running_mean[c] = __fadd_rn(__fmul_rn(keep, running_mean[c]), __fmul_rn(momentum, mean32));
        running_var[c] = __fadd_rn(__fmul_rn(keep, running_var[c]), __fmul_rn(momentum, unbiased));
      }
    }
  }
  if (writer && batches != nullptr && blockIdx.y == 0 && l.col == 0) *batches += 1;
  const bool on = relu != 0;
  const long long tile = static_cast<long long>(l.rows) * kUnroll;
  for (long long base = blockIdx.x * tile + l.row; base < M; base += gridDim.x * tile) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = base + static_cast<long long>(u) * l.rows;
      if (r < M) raw[u] = load16(x + r * C + l.c0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = base + static_cast<long long>(u) * l.rows;
      if (r >= M) continue;
      const T* e = reinterpret_cast<const T*>(&raw[u]);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        bool kept;
        o[i] = affine<T>(to_f32<T>(e[i]), mult[i], shift[i], on, &kept);
      }
      *reinterpret_cast<uint4*>(y + r * C + l.c0) = out;
    }
  }
}

// 3. Σdy', Σdy'·(x − mean) per channel (out rows 0, 1), and this rank's dγ =
// r·Σdy'(x − mean), dβ = Σdy' (rows 2, 3).
template <typename T>
__global__ void __launch_bounds__(kBlock) batchnorm_grad_sums_kernel(const T* __restrict__ x,
                                                                      const T* __restrict__ dy, long long M, int C,
                                                                      const float* __restrict__ table, int relu,
                                                                      double* partial, unsigned* counters,
                                                                      float* __restrict__ out) {
  constexpr int V = 16 / sizeof(T);
  const Lane l = lane<T>(C);
  double a1[V], a2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) a1[i] = a2[i] = 0.0;
  if (l.active) {
    float mean[V], mult[V], shift[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      mean[i] = table[kMean * C + l.c0 + i];
      mult[i] = table[kMult * C + l.c0 + i];
      shift[i] = table[kShift * C + l.c0 + i];
    }
    const bool on = relu != 0;
    const long long tile = static_cast<long long>(l.rows) * kUnroll;
    for (long long base = blockIdx.x * tile + l.row; base < M; base += gridDim.x * tile) {
      uint4 xr[kUnroll], gr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long r = base + static_cast<long long>(u) * l.rows;
        const bool in = r < M;
        xr[u] = in ? load16(x + r * C + l.c0) : make_uint4(0, 0, 0, 0);
        gr[u] = in ? load16(dy + r * C + l.c0) : make_uint4(0, 0, 0, 0);
      }
      float f1[V], f2[V];
#pragma unroll
      for (int i = 0; i < V; ++i) f1[i] = f2[i] = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const T* xe = reinterpret_cast<const T*>(&xr[u]);
        const T* ge = reinterpret_cast<const T*>(&gr[u]);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xv = to_f32<T>(xe[i]);
          bool kept;
          affine<T>(xv, mult[i], shift[i], on, &kept);
          // rows past M read zeros: their dy' is 0 whatever the mask says
          const float d = kept ? to_f32<T>(ge[i]) : 0.f;
          f1[i] += d;
          f2[i] = __fmaf_rn(d, __fsub_rn(xv, mean[i]), f2[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        a1[i] += f1[i];
        a2[i] += f2[i];
      }
    }
  }
  double total;
  if (!block_sums<V>(a1, a2, l, partial, counters, &total)) return;
  const int t = threadIdx.x;
  if (t < 2 * l.width * V) {
    const int s = t / (l.width * V), c = sum_channel(t, l.width, V);
    const float sum = static_cast<float>(total);
    out[s * C + c] = sum;
    if (s == 0) out[3 * C + c] = sum;                                   // dβ
    else out[2 * C + c] = __fmul_rn(table[kRstd * C + c], sum);          // dγ
  }
}

// 4. dx from the backward sums (out rows 0, 1 of 3, all-reduced where the
// batch is synchronised).
template <typename T>
__global__ void __launch_bounds__(kBlock) batchnorm_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                                               T* __restrict__ dx, long long M, int C,
                                                               const float* __restrict__ table,
                                                               const float* __restrict__ gamma,
                                                               const float* __restrict__ sums, double n, int relu) {
  constexpr int V = 16 / sizeof(T);
  const Lane l = lane<T>(C);
  if (!l.active) return;
  float mean[V], mult[V], shift[V], b[V], k[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = l.c0 + i;
    mean[i] = table[kMean * C + c];
    mult[i] = table[kMult * C + c];
    shift[i] = table[kShift * C + c];
    const double r = table[kRstd * C + c];
    const double dvar = -0.5 * r * r * r * static_cast<double>(gamma[c]) * static_cast<double>(sums[C + c]);
    b[i] = static_cast<float>(2.0 * dvar / n);
    k[i] = static_cast<float>(-static_cast<double>(mult[i]) * static_cast<double>(sums[c]) / n);
  }
  const bool on = relu != 0;
  const long long tile = static_cast<long long>(l.rows) * kUnroll;
  for (long long base = blockIdx.x * tile + l.row; base < M; base += gridDim.x * tile) {
    uint4 xr[kUnroll], gr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = base + static_cast<long long>(u) * l.rows;
      if (r < M) {
        xr[u] = load16(x + r * C + l.c0);
        gr[u] = load16(dy + r * C + l.c0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = base + static_cast<long long>(u) * l.rows;
      if (r >= M) continue;
      const T* xe = reinterpret_cast<const T*>(&xr[u]);
      const T* ge = reinterpret_cast<const T*>(&gr[u]);
      uint4 res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xv = to_f32<T>(xe[i]);
        bool kept;
        affine<T>(xv, mult[i], shift[i], on, &kept);
        const float d = kept ? to_f32<T>(ge[i]) : 0.f;
        o[i] = from_f32<T>(__fmaf_rn(d, mult[i], __fmaf_rn(__fsub_rn(xv, mean[i]), b[i], k[i])));
      }
      *reinterpret_cast<uint4*>(dx + r * C + l.c0) = res;
    }
  }
}

// The grid of a launch: row tiles (x) by channel slices (y). The stats and
// sums passes take about kStatsBlocksPerSM blocks an SM, fewer where the
// rows run out or the scratch cannot hold their partials; the elementwise
// passes about kApplyBlocksPerSM.
template <typename T>
dim3 grid_of(long long M, int C, int device, int per_sm, long long scratch_bytes) {
  constexpr int V = 16 / sizeof(T);
  const int cols = C / V;
  const int slices = (cols + kSliceVectors - 1) / kSliceVectors;
  const int rows = kBlock / min(kSliceVectors, cols);
  const long long tiles = (M + static_cast<long long>(rows) * kUnroll - 1) / (static_cast<long long>(rows) * kUnroll);
  long long gx = std::max<long long>(1, static_cast<long long>(per_sm) * sm_count(device) / slices);
  gx = std::min(gx, tiles);
  if (scratch_bytes > 0) {
    const long long per_block = 2LL * kSliceVectors * V * sizeof(double);
    gx = std::min(gx, (scratch_bytes - kCounterBytes) / (per_block * slices));
  }
  return dim3(static_cast<unsigned>(std::max<long long>(gx, 1)), static_cast<unsigned>(slices));
}

// Argument checks every entry shares: C a whole number of 16-byte vectors
// and at most kMaxSlices slices of them, at least one row, the scratch
// large enough for one block a slice.
template <typename T>
bool shape_ok(long long M, int C, long long scratch_bytes) {
  constexpr int V = 16 / sizeof(T);
  if (M <= 0 || C <= 0 || C % V) return false;
  const long long slices = (C / V + kSliceVectors - 1) / kSliceVectors;
  if (slices > kMaxSlices) return false;
  return scratch_bytes < 0 || scratch_bytes >= kCounterBytes + slices * 2LL * kSliceVectors * V * 8;
}

template <typename T>
int run_stats(const void* x, long long M, int C, void* scratch, long long scratch_bytes, float* sums,
              void* stream, int device) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!shape_ok<T>(M, C, scratch_bytes)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = grid_of<T>(M, C, device, kStatsBlocksPerSM, scratch_bytes);
  char* s = static_cast<char*>(scratch);
  batchnorm_stats_kernel<T><<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), M, C, reinterpret_cast<double*>(s + kCounterBytes), reinterpret_cast<unsigned*>(s),
      sums);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_relu(const void* x, void* y, long long M, int C, const float* sums, const float* gamma, const float* beta,
             double n, double eps, int relu, float* table, float* running_mean, float* running_var,
             long long* batches, float keep, float momentum, float unbias, void* stream, int device) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!shape_ok<T>(M, C, -1)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = grid_of<T>(M, C, device, kApplyBlocksPerSM, 0);
  batchnorm_relu_kernel<T><<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(y), M, C, sums, gamma, beta, n, eps, relu, table, running_mean,
      running_var, batches, keep, momentum, unbias);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_grad_sums(const void* x, const void* dy, long long M, int C, const float* table, int relu, void* scratch,
                  long long scratch_bytes, float* out, void* stream, int device) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!shape_ok<T>(M, C, scratch_bytes)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = grid_of<T>(M, C, device, kStatsBlocksPerSM, scratch_bytes);
  char* s = static_cast<char*>(scratch);
  batchnorm_grad_sums_kernel<T><<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), M, C, table, relu,
      reinterpret_cast<double*>(s + kCounterBytes), reinterpret_cast<unsigned*>(s), out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_dx(const void* x, const void* dy, void* dx, long long M, int C, const float* table, const float* gamma,
           const float* sums, double n, int relu, void* stream, int device) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!shape_ok<T>(M, C, -1)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = grid_of<T>(M, C, device, kApplyBlocksPerSM, 0);
  batchnorm_dx_kernel<T><<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx), M, C, table, gamma, sums, n, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entry points. `dtype`: 0 bf16, 1 fp16, 2 fp32 (x, y, dy and dx alike; every
// other array fp32). x (and dy, y, dx) are (M, C) row-major, contiguous and
// 16-byte aligned, C a multiple of 16 / sizeof(element); `scratch` is the
// caller's per-stream buffer of `scratch_bytes` (at least
// pcmseg_batchnorm_scratch_bytes()), zeroed once before its first use: the
// kernels leave its counters at 0. Each returns the cudaError_t of its launch
// on `stream` of `device` and does not synchronise.
extern "C" {

// Bytes of the scratch: the counters, and the partials of kMaxSlices blocks
// of 8 channels a vector (more blocks of fewer slices).
long long pcmseg_batchnorm_scratch_bytes() {
  return kCounterBytes + static_cast<long long>(kMaxSlices) * 2 * kSliceVectors * 8 * sizeof(double);
}

// 1: sums (2 x C) = Σx, Σx².
int pcmseg_batchnorm_stats(int dtype, const void* x, long long M, int C, void* scratch, long long scratch_bytes,
                           float* sums, void* stream, int device) {
  switch (dtype) {
    case 0: return run_stats<bf16>(x, M, C, scratch, scratch_bytes, sums, stream, device);
    case 1: return run_stats<f16>(x, M, C, scratch, scratch_bytes, sums, stream, device);
    case 2: return run_stats<float>(x, M, C, scratch, scratch_bytes, sums, stream, device);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// 2: y from x and sums over n voxels; table (8 x C) rows mean, var, unbiased
// var (var·unbias), r, mult, shift. With running_mean (else NULL) the running
// statistics move to keep·running + momentum·(mean, unbiased var) and
// *batches grows by one.
int pcmseg_batchnorm_relu(int dtype, const void* x, void* y, long long M, int C, const float* sums,
                          const float* gamma, const float* beta, double n, double eps, int relu, float* table,
                          float* running_mean, float* running_var, long long* batches, float keep, float momentum,
                          float unbias, void* stream, int device) {
  switch (dtype) {
    case 0: return run_relu<bf16>(x, y, M, C, sums, gamma, beta, n, eps, relu, table, running_mean, running_var,
                                  batches, keep, momentum, unbias, stream, device);
    case 1: return run_relu<f16>(x, y, M, C, sums, gamma, beta, n, eps, relu, table, running_mean, running_var,
                                 batches, keep, momentum, unbias, stream, device);
    case 2: return run_relu<float>(x, y, M, C, sums, gamma, beta, n, eps, relu, table, running_mean, running_var,
                                   batches, keep, momentum, unbias, stream, device);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// 3: out (4 x C) rows Σdy', Σdy'·(x − mean), dγ, dβ, from the forward's table.
int pcmseg_batchnorm_grad_sums(int dtype, const void* x, const void* dy, long long M, int C, const float* table,
                               int relu, void* scratch, long long scratch_bytes, float* out, void* stream,
                               int device) {
  switch (dtype) {
    case 0: return run_grad_sums<bf16>(x, dy, M, C, table, relu, scratch, scratch_bytes, out, stream, device);
    case 1: return run_grad_sums<f16>(x, dy, M, C, table, relu, scratch, scratch_bytes, out, stream, device);
    case 2: return run_grad_sums<float>(x, dy, M, C, table, relu, scratch, scratch_bytes, out, stream, device);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// 4: dx from x, dy, the forward's table, γ and the sums (2 x C) of 3 over n voxels.
int pcmseg_batchnorm_dx(int dtype, const void* x, const void* dy, void* dx, long long M, int C, const float* table,
                        const float* gamma, const float* sums, double n, int relu, void* stream, int device) {
  switch (dtype) {
    case 0: return run_dx<bf16>(x, dy, dx, M, C, table, gamma, sums, n, relu, stream, device);
    case 1: return run_dx<f16>(x, dy, dx, M, C, table, gamma, sums, n, relu, stream, device);
    case 2: return run_dx<float>(x, dy, dx, M, C, table, gamma, sums, n, relu, stream, device);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
