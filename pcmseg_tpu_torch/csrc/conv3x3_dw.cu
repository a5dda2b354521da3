// Weight gradient of the 3x3x3 SAME convolution over NDHWC, bf16 or fp16 in
// (one template, two entry points), fp32 out, for Hopper (sm_90a):
// warpgroup wgmma fed by TMA.
//
// Replaces the Pallas TPU kernel
// pcmseg_tpu/ops/pallas/conv3d_grad.py::conv3x3_dw (pl.pallas_call body
// `_dw_kernel`). Same arithmetic: dW[tap, ci, co] = sum over every voxel v of
// the batch of x[v + offset(tap), ci] * dy[v, co], neighbours outside the
// volume read as zero, products of 16-bit values (exact in fp32, subnormal
// fp16 values included) summed in fp32. fp16 takes the bf16 design, with
// each chain's dy scaled by a power of two on chip (below).
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
//    the three kw taps' running totals, m64n64 fp32 each, in registers (96
//    per thread), so 9 taps share every tile of x and dy in shared memory;
//  * accuracy: the tensor cores' fp32 sums do not round to nearest. On an
//    H100 a k16 step into an accumulator loses about 2^-23 of its value
//    (0.72 of that on average, truncation toward zero), so one chain over
//    a whole split-K slice (up to 5,960 steps) lost 5.4e-4 of a same-sign
//    sum. A consumer runs each tap's chain over CHAIN_TILES voxel tiles
//    (8 k16 steps a tile) into one fresh accumulator (scale-d 0), waits for
//    it and adds it into the tap's running total (an FFMA: times the
//    chain's 2^-k below), tap by tap in a fixed order: no chain is longer
//    than 8 * CHAIN_TILES steps, and the totals round to nearest. Two tiles
//    a chain (16 steps) halve the waits of one; the other two warpgroups'
//    chains keep the tensor cores busy while one waits and adds;
//  * registers: the totals (96) and the fresh accumulator (32) alone fill
//    the 128 registers a thread of a 416-thread block (3 warpgroups and a
//    producer warp) may have; so the producer is a whole warpgroup that
//    gives its registers to the consumers (setmaxnreg, 144 a consumer, 64
//    a producer thread: the fp16 scaling warps hold a tile's share);
//  * one producer thread walks 2x8x8-voxel tiles (K = 128 voxels, eight
//    k16 steps of two x-rows each) through a 4-stage TMA ring on mbarriers:
//    dy as one 5-D box of 64 channels with the 128-byte swizzle, the x halo
//    (2x10x10 voxels, shifted by kd in z) as one 5-D box of 64 channels in
//    128-byte swizzled rows (200 rows a tile; eight boxes of 16-byte rows
//    cost 6-9% more). TMA's zero fill at out-of-volume coordinates is the
//    SAME padding. A halo row is a voxel, so a tap (kh, kw) is a start
//    address a whole number of rows on (TMA and wgmma swizzle by the
//    address's own bits): x is read once per tile, not once per tap, and dy
//    once per (kd, ci block) instead of once per 16 channels;
//  * Ci = 8 (the padded input conv): one block holds all 27 taps, the halo
//    (4x10x10 voxels) in 16-byte rows without swizzle. A warpgroup's m64
//    tile is (kw, ci) for kw = 0..2 at 16-byte steps of the halo (rows
//    24-63 are discarded), one running total per kd;
//  * the voxel sum is split over gridDim.z (split-K) into whole waves of
//    blocks; a second pass adds the fp32 partials in split order, so two
//    runs agree bit for bit. The TPU kernel's H-chunking (_pick_chunk_h)
//    was VMEM bookkeeping and has no counterpart;
//  * fp16 range: on an H100 the tensor cores align the products of a sum
//    to the largest exponent and keep about 25 bits below it, and a
//    subnormal fp16 operand enters at exponent -14 with its leading zeros:
//    4*2^-24 + (1 + 2^-10)*2^-28 loses its 2^-38 bit, the same sum times
//    2^20 is exact. With no loss scaling the fp16 step's dy is nearly all
//    zero and the rest subnormal (2^-24..2^-21 at the 8^3 bottleneck), and
//    such elements lost up to 2.2e-5 of their sum of |x.dy| (cuBLAS's fp16
//    GEMM with fp32 output the same). So each fp16 chain sums dy.2^k,
//    k = f16_scale_exponent(the chain's max|dy|), and its accumulator is
//    multiplied by 2^-k as it is added into the total. Both are exact:
//    dy.2^k stays below 2^15, and a nonzero sum of fp16 products is a
//    multiple of 2^-48 with k <= 38, so acc.2^-k stays in fp32's normal
//    range. The producer warpgroup's three idle warps find and apply the
//    scale in shared memory, between a dy tile's TMA load (its own
//    mbarrier, ahead of x's) and the consumers' wgmma (a third mbarrier a
//    stage): each thread loads its 11 words of the tile at once, the three
//    warps reduce max|dy| (one named barrier), the words are scaled in
//    registers and stored back (one read and one write a word, none for a
//    word of zeros), and each thread fences and arrives. No pass over dy
//    before the kernel, nothing in device memory. B2 is bound by shared
//    memory (m64n64k16 with both operands there reads 128 bytes a clock at
//    the tensor cores' rate), so the scaling warps' 32 KB a tile is what
//    fp16 pays over bf16. Loading dy through registers from L2 instead (no
//    shared-memory read) is held back by the few loads in flight the spare
//    registers allow; and the thread that issues the TMA loads stays apart
//    from the scaling warps, so the loads run STAGES tiles ahead. A chain's
//    first tile is scaled by its own exponent; its second tile by the
//    pair's, and where that is lower than the first's (the second holds the
//    larger |dy|) the pair is cut into two chains of one tile, each with
//    its own exponent; a first tile of zeros takes the pair's. The
//    exponents lie in a slot beside the stage's barriers. Every chain's
//    largest |dy| lands in [2^14, 2^15) but where its exponent is 0.

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int TZ = 2, TY = 8, TX = 8;  // voxel tile: 128 voxels, k16 step j = z j/4, y rows 2(j%4)..+1
constexpr int HY = TY + 2, HX = TX + 2;
constexpr int VOX = TZ * TY * TX;
constexpr int BC = 64;               // input and output channels per block
constexpr int DY_BYTES = VOX * 128;  // dy tile: 128 voxel rows of 64 channels, 128-byte swizzled
constexpr int DY_WORDS = DY_BYTES / 16;
constexpr int THREADS = 512;         // 3 consumer warpgroups (kh) + 1 producer warpgroup
constexpr int SCALERS = 96;          // fp16: the producer warpgroup's warps 1-3 scale dy tiles
constexpr int WORDS = (DY_WORDS + SCALERS - 1) / SCALERS;  // 16-byte words of a tile a scaler holds
// registers a thread after setmaxnreg: 4 x 128 x 128 at launch, 128 x 64 + 384 x 144 after
constexpr int PRODUCER_REGS = 64, CONSUMER_REGS = 144;
constexpr int STAGES = 4;
constexpr int MIN_TILES_PER_SPLIT = 4;
constexpr int CHAIN_TILES = 2;  // voxel tiles a tensor-core chain spans (8 k16 steps each)

template <bool SMALL>
struct DwCfg {
  static constexpr int HZ = SMALL ? TZ + 2 : TZ;  // SMALL covers all three kd
  static constexpr int ROW = SMALL ? 16 : 128;    // a halo voxel's bytes: 8 channels, or 64 swizzled
  static constexpr int X_BYTES = HZ * HY * HX * ROW;
  // + slack: SMALL's discarded rows 24-63 read a few rows past its halo
  static constexpr int STAGE = (DY_BYTES + X_BYTES + 256 + 1023) / 1024 * 1024;
  static constexpr int BAR_OFF = STAGES * STAGE;
  // full, empty, dy_full, scaled (8 bytes each a stage), each stage's
  // exponent (4), the scaling warps' maxima (two sets of 4 x 4)
  static constexpr int K_OFF = BAR_OFF + 32 * STAGES, PART_OFF = K_OFF + 4 * STAGES;
  static constexpr int SMEM = PART_OFF + 32 + 1024;  // + alignment slack
};

struct DwArgs {
  float* dst;  // (27, Ci, Co) fp32, one slab per split
  int Ci, Co;
  int tiles_z, tiles_y, tiles_x, tiles;
  int tiles_per_split;
};

// The exponent k of the fp16 dy scale for a largest |dy| of fp16 bits
// `amax_bits` (sign cleared): max|dy| * 2^k in [2^14, 2^15), so nothing
// in dy * 2^k passes 65504; 0 (no scale) for a zero, inf or NaN maximum and
// for max|dy| >= 2^14. (conv3d_grad.f16_scale_exponent is its mirror.)
__host__ __device__ inline int f16_scale_exponent(unsigned amax_bits) {
  if (amax_bits == 0 || amax_bits >= 0x7c00u) return 0;
  int e;  // max|dy| in [2^(e-1), 2^e)
  if (amax_bits >> 10) {
    e = static_cast<int>(amax_bits >> 10) - 14;  // normal: 1.m * 2^(E-15)
  } else {
    int b = 0;  // subnormal: m * 2^-24, m in [2^b, 2^(b+1))
    while (amax_bits >> (b + 1)) ++b;
    e = b - 23;
  }
  return 15 - e > 0 ? 15 - e : 0;
}

// 2^k as an fp32 bit pattern, for |k| <= 126
__device__ inline float pow2f(int k) { return __int_as_float((127 + k) << 23); }

// The largest |value| of the 8 fp16 values in q, as bits (they order as the values do).
__device__ inline unsigned f16_absmax8(const uint4& q) {
  constexpr unsigned M = 0x7fff7fffu;
  const unsigned m = __vmaxu2(__vmaxu2(q.x & M, q.y & M), __vmaxu2(q.z & M, q.w & M));
  return max(m & 0xffffu, m >> 16);
}

// T: the element type of x and dy (bf16 or f16; fp16 scales dy per chain).
template <bool SMALL, typename T>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_dw_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap dymap,
                      const DwArgs a) {
  using C = DwCfg<SMALL>;
  constexpr bool SCALED = std::is_same<T, f16>::value;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzled tiles want 1024
  unsigned char* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bar = base + C::BAR_OFF;
  auto full = [&](int s) { return bar + 8 * s; };  // x landed (bf16: and dy)
  auto empty = [&](int s) { return bar + 8 * (STAGES + s); };
  auto dy_full = [&](int s) { return bar + 8 * (2 * STAGES + s); };  // fp16: dy landed
  auto scaled = [&](int s) { return bar + 8 * (3 * STAGES + s); };   // fp16: dy scaled, its exponent set
  volatile int* const k_of = reinterpret_cast<int*>(gbase + C::K_OFF);  // fp16: a stage's chain exponent

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 3);
      mbar_init(dy_full(s), 1);
      mbar_init(scaled(s), SCALED ? SCALERS : 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int kd = SMALL ? 0 : blockIdx.x % 3;
  const int ci0 = SMALL ? 0 : (blockIdx.x / 3) * BC;
  const int co0 = blockIdx.y * BC;
  const int t_begin = blockIdx.z * a.tiles_per_split;
  const int t_end = min(a.tiles, t_begin + a.tiles_per_split);
  const int tiles = t_end - t_begin;

  if (tid >= 384) {  // producer warpgroup: one thread issues every TMA load
    setmaxnreg_dec<PRODUCER_REGS>();
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
        if (SCALED) {  // dy first, on its own barrier: the scaling warps start on it before x lands
          mbar_expect_tx(dy_full(s), DY_BYTES);
          tma_load_5d(st, &dymap, dy_full(s), co0, x0, y0, z0, n);
          mbar_expect_tx(full(s), C::X_BYTES);
        } else {
          mbar_expect_tx(full(s), DY_BYTES + C::X_BYTES);
          tma_load_5d(st, &dymap, full(s), co0, x0, y0, z0, n);
        }
        tma_load_5d(st + DY_BYTES, &xmap, full(s), ci0, x0 - 1, y0 - 1, z0 - 1 + kd, n);
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    } else if (SCALED && tid >= 416) {
      // the scaling warps: dy * 2^k in place, each stage between its TMA
      // load and the wgmma that read it (the async proxy: each thread
      // fences, then arrives on the scaled barrier)
      const int stid = tid - 416;
      unsigned* const part = reinterpret_cast<unsigned*>(gbase + C::PART_OFF);
      int s = 0;
      unsigned m_first = 0;  // max|dy| of the chain's first tile
      uint32_t ph = 0;
      for (int i = 0; i < tiles; ++i) {
        mbar_wait(dy_full(s), ph);
        uint4* const tile = reinterpret_cast<uint4*>(gbase + s * C::STAGE);
        uint4 q[WORDS];
#pragma unroll
        for (int u = 0; u < WORDS; ++u)
          q[u] = stid + u * SCALERS < DY_WORDS ? tile[stid + u * SCALERS] : make_uint4(0, 0, 0, 0);
        unsigned m = 0;
#pragma unroll
        for (int u = 0; u < WORDS; ++u) m = max(m, f16_absmax8(q[u]));
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
        unsigned* const pp = part + 4 * (i & 1);  // two sets: the next tile's writes wait for no reader
        if ((stid & 31) == 0) pp[stid >> 5] = m;
        named_barrier(1, SCALERS);
        m = max(max(pp[0], pp[1]), pp[2]);
        int k;
        if (i % CHAIN_TILES == 0) {  // a chain's first tile: its own exponent
          k = f16_scale_exponent(m);
          m_first = m;
        } else {  // the second: the pair's; the pair stays one chain unless that is below the first's
          k = f16_scale_exponent(max(m, m_first));
        }
        if (k > 0) {
          // times 2^k in fp16 steps of at most 2^15, each exact: a value scaled
          // up keeps every bit, and it only grows toward dy.2^k < 2^15
          for (int left = k; left > 0; left -= 15) {
            const unsigned short bits = static_cast<unsigned short>((15 + min(left, 15)) << 10);  // 2^min(left, 15)
            const __half2 f = __half2half2(__ushort_as_half(bits));
#pragma unroll
            for (int u = 0; u < WORDS; ++u) {
              __half2* h = reinterpret_cast<__half2*>(&q[u]);
#pragma unroll
              for (int j = 0; j < 4; ++j) h[j] = __hmul2(h[j], f);
            }
          }
#pragma unroll
          for (int u = 0; u < WORDS; ++u) {  // a word of zeros scales to itself
            const bool zero = (q[u].x | q[u].y | q[u].z | q[u].w) == 0;
            if (stid + u * SCALERS < DY_WORDS && !zero) tile[stid + u * SCALERS] = q[u];
          }
        }
        fence_proxy_async();
        if (stid == 0) {
          k_of[s] = k;
          // a first tile of zeros takes the pair's exponent (any scale leaves it as it is)
          if (i % CHAIN_TILES != 0 && m_first == 0) k_of[s == 0 ? STAGES - 1 : s - 1] = k;
        }
        mbar_arrive(scaled(s));
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  // consumers: warpgroup kh, running totals aa = kw (SMALL: aa = kd)
  const int kh = tid >> 7;
  float total[3][32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    acc[i] = 0.f;
#pragma unroll
    for (int aa = 0; aa < 3; ++aa) total[aa][i] = 0.f;
  }
  fence_regs(acc);

  // local tile i is t_begin + i, in stage i % STAGES, its n-th use of the stage i / STAGES
  auto ready = [&](int i) {
    mbar_wait(full(i % STAGES), (i / STAGES) & 1);
    if (SCALED) mbar_wait(scaled(i % STAGES), (i / STAGES) & 1);
  };
  // the chains of the NT local tiles from i0: per tap one fresh accumulator
  // over their 8 * NT k16 steps, then added into the tap's running total
  // times 2^-k (fp16: the chain's dy scale; bf16: 1)
  auto chain = [&](auto nt, int i0) {
    constexpr int NT = decltype(nt)::value;
#pragma unroll
    for (int q = 0; q < NT; ++q) ready(i0 + q);
    const float down = SCALED ? pow2f(-k_of[i0 % STAGES]) : 1.f;
#pragma unroll
    for (int aa = 0; aa < 3; ++aa) {
      wgmma_fence();  // the adds below read acc
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        const uint32_t st = base + ((i0 + q) % STAGES) * C::STAGE, xs = st + DY_BYTES;
#pragma unroll
        for (int j = 0; j < VOX / 16; ++j) {
          const int zz = j / 4, yy = (j % 4) * 2;
          const uint64_t db = gmma_desc(st + j * 2048, 16, 1024, LAYOUT_B128);
          // halo row of the step's first voxel, shifted by the tap; the next
          // 8 voxels (y + 1) are HX rows on; SMALL: 16-byte rows, the next 8
          // channels one slab on (none: Ci = 8), the next 8 M rows the next
          // kw (16 bytes)
          const int row = SMALL ? ((zz + aa) * HY + yy + kh) * HX : (zz * HY + yy + kh) * HX + aa;
          const uint64_t da = SMALL ? gmma_desc(xs + row * 16, HX * 16, 16, LAYOUT_INTERLEAVE)
                                    : gmma_desc(xs + row * 128, 16, HX * 128, LAYOUT_B128);
          wgmma_m64n64k16<1, 1, T>(acc, da, db, q > 0 || j > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int k = 0; k < 32; ++k) total[aa][k] = fmaf(acc[k], down, total[aa][k]);
    }
    // every wgmma that read these stages has completed
    if ((tid & 127) == 0) {
#pragma unroll
      for (int q = 0; q < NT; ++q) mbar_arrive(empty((i0 + q) % STAGES));
    }
  };
  int i0 = 0;
  for (; i0 + CHAIN_TILES <= tiles; i0 += CHAIN_TILES) {
    if (SCALED) {  // a pair whose exponents differ runs as two chains
      ready(i0);
      ready(i0 + 1);
      if (k_of[i0 % STAGES] != k_of[(i0 + 1) % STAGES]) {
        chain(std::integral_constant<int, 1>(), i0);
        chain(std::integral_constant<int, 1>(), i0 + 1);
        continue;
      }
    }
    chain(std::integral_constant<int, CHAIN_TILES>(), i0);
  }
  for (; i0 < tiles; ++i0) chain(std::integral_constant<int, 1>(), i0);

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
          *reinterpret_cast<float2*>(row + co) = make_float2(total[aa][4 * j + 2 * h], total[aa][4 * j + 2 * h + 1]);
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

// The launches of one dW in element type T (the entry points below): the
// kernel, then, where the voxels are split, the sum of the partials.
template <typename T>
int run_dw(const void* x, const void* dy, void* out, void* workspace, long long workspace_bytes, int N, int D,
           int H, int W, int Ci, int Co, void* stream, int device) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!(Ci == 8 || Ci % BC == 0) || Co % 8) return static_cast<int>(cudaErrorInvalidValue);
  const DwPlan p = make_dw_plan(N, D, H, W, Ci, Co, sm_count(device));
  if (workspace_bytes < p.workspace_bytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  CUtensorMap xmap, dymap;
  constexpr CUtensorMapDataType type = tensor_map_type<T>();
  err = make_ndhwc_map(&xmap, x, N, D, H, W, Ci, p.small ? 8 : BC, HX, HY, p.small ? TZ + 2 : TZ, !p.small, type);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = make_ndhwc_map(&dymap, dy, N, D, H, W, Co, BC, TX, TY, TZ, true, type);
  if (err != cudaSuccess) return static_cast<int>(err);

  DwArgs a;
  a.dst = p.splits > 1 ? static_cast<float*>(workspace) : static_cast<float*>(out);
  a.Ci = Ci, a.Co = Co;
  a.tiles_z = p.tiles_z, a.tiles_y = p.tiles_y, a.tiles_x = p.tiles_x, a.tiles = p.tiles;
  a.tiles_per_split = p.tiles_per_split;
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

// Bytes of workspace the launches below need for this shape on `device`
// (bf16 and fp16 alike): the fp32 split-K partials, 0 unless the voxels
// are split.
long long pcmseg_conv3x3_dw_workspace_bytes(int N, int D, int H, int W, int Ci, int Co, int device) {
  return make_dw_plan(N, D, H, W, Ci, Co, sm_count(device)).workspace_bytes;
}

// f16_scale_exponent for the tests: the exponent of a chain's dy scale
// given the fp16 bits of its max|dy|.
int pcmseg_f16_scale_exponent(int amax_bits) { return f16_scale_exponent(static_cast<unsigned>(amax_bits)); }

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
