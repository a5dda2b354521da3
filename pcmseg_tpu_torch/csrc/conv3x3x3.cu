// Fused 3x3x3 SAME convolution + bias + optional ReLU over NDHWC, bf16 or
// fp16 in and out (one template, two entry points), fp32 accumulation, for
// Hopper (sm_90a): warpgroup wgmma fed by TMA, persistent blocks, split K
// summed on chip across a thread block cluster.
//
// Replaces the Pallas TPU kernel pcmseg_tpu/ops/pallas/conv3d.py::conv3x3x3
// (pl.pallas_call body `_kernel`), which computes in x's dtype. Same
// arithmetic: out = max(sum over the 27 taps of window . W_tap + b, 0),
// accumulated in fp32, bias added in fp32, then ReLU, then one rounding to
// x's dtype (round to nearest even; fp16 keeps subnormals and gives +-inf
// past 65504, as astype does). With relu off, no bias and the flipped,
// Ci<->Co-transposed weight it is also the convolution's dx. bf16 and fp16
// share every instruction shape, byte and tile (wgmma .f16 runs at bf16's
// rate).
//
// Formulation: implicit GEMM, M = output voxels, N = Co, K = 27*Ci with
// k = tap*Ci + ci and tap = (kd*3 + kh)*3 + kw. The weight is packed once per
// load as a (Co, 27*Ci) row-major matrix in x's dtype. The kernel takes Ci == 8 or a
// multiple of 64 (the wrapper zero-pads x's channels, e.g. the Ci = 5 input
// conv to 8) and Co % 8 == 0.
//
// What bounds it on an H100 (989 TFLOP/s bf16 / fp16 dense, 3.35 TB/s, 132
// SMs): a layer does 27*Ci*Co/(Ci+Co) FLOP per byte of x and y, 864 for
// 64->64, far above the ~295 ridge; only the Ci = 8 input conv is bound by
// its bytes. So the tensor cores are what a layer should wait for. What
// kept them waiting, by shape class, and what the design does about it
// (tools/ablate_conv3x3x3.py, CUDA-graph times on an H100 80GB HBM3 at
// 700 W; PERF.md):
//
//  * every layer, latency: in the design before this one (two 100-110 KB
//    blocks an SM, one halo buffer, the epilogue's stores from registers) a
//    block loaded its halo, ran its wgmma, then stored its tile, overlapped
//    only by the SM's other block: with the wgmma taken out that pipeline
//    alone took 0.71 of 0.93 ms at 64->64 @128^3 and 1.58 of 1.68 ms at
//    64->128 @128^3. Here one block an SM (197-229 KB) walks its tiles in
//    a fixed order: a halo thread fills two halo buffers, so the next
//    chunk's or tile's halo lands while this one's wgmma run; a weight
//    thread keeps a ring of weight tiles full across chunk and tile
//    boundaries; two accumulator sets let a tile's epilogue (bias, ReLU,
//    the rounding, into shared memory, then one TMA store per 64 channels)
//    run while the next tile's first wgmma groups are queued. The producer
//    warpgroup gives its registers to the consumers (setmaxnreg 40 / 232),
//    so the second accumulator set does not spill;
//  * every layer, TMA rows: a TMA load costs by the row as much as by the
//    byte. x's halo as eight boxes of 8 channels (16-byte rows: 3,200 rows
//    a chunk at BN = 128) cost as much as the chunk's 27 weight tiles
//    (3,456 rows of 128 bytes), and 28% of a split block's time at 8^3.
//    So a chunk's halo is one box of 64 channels in 128-byte rows (400),
//    swizzled: 5-20% less time at the shapes at 32^3 and below;
//  * the wgmma issue, once the loads hide behind it: m64nBNk16 with both
//    operands in shared memory reads 128 B a tensor-core cycle at BN = 64
//    (all an SM has) and 96 at BN = 128. The instruction shapes are the
//    design before's. Co = 64 on wgmma's M side (m64n128k16 over 16 y rows
//    of voxels) would need a 4x18x10 halo, 92 KB a buffer: with two of
//    them, the weight ring and the staged tile, more than an SM's 227 KB;
//  * the deep levels (16^3, 8^3; 16-512 tiles a layer): too few tiles to
//    fill the card, or a K longer than one chain. Unsplit, persistent
//    blocks run the tiles they have, K whole, their chains cut (below).
//    Split, K's weight tiles (27 to a chunk) go in equal slices over
//    gridDim.z, the splits of a tile being the blocks of one cluster (at
//    most 8): each writes its fp32 partial into its own shared memory and,
//    after a cluster barrier, owns a slice of the tile, adds the partials
//    of blocks 0, 1, ... in that order through distributed shared memory,
//    applies bias, ReLU and the one rounding and stores its slice: no
//    workspace, no second launch, bitwise repeatable. A cluster's blocks
//    share one GPC, so the card holds fewer clusters than SMs / size
//    (132, 66, 39, 30, 22, 17, 15, 15 of sizes 1..8: max_clusters), and a
//    split block costs its own fill, barriers and sum (8-13 us at 8^3,
//    about 24 weight tiles' time). make_plan weighs both (plan_cost); a
//    slice may start and end at any tap, so 16 tiles split 6 ways (17
//    clusters of 6 fit at once), where whole chunks would split 4 or 8;
//  * accuracy: the tensor cores' fp32 sums truncate about 0.72*2^-23 of
//    the running sum a k16 step (PERF.md). No chain runs more than
//    CHAIN_CHUNKS chunks (at most 4 * 27 * 4 = 432 k16 steps): a block
//    whose slice is longer than that starts a fresh chain at every fourth
//    chunk it spans, whole or in part, and adds each into fp32 running
//    totals with FADDs (CUT); the splits' partials are added in fp32 in
//    rank order;
//  * A, the activations, is read by the tensor cores straight from shared
//    memory: for each 64-channel chunk the tile's (2*MZ+2)x10x10 x halo
//    comes by TMA as one 5-D box of 128-byte rows (a voxel's 64 channels)
//    with TMA's 128-byte swizzle, wgmma's swizzled K-major layout: 8-row
//    groups (8 halo voxels adjacent in x) lie HX*128 bytes apart (the y
//    rows), a k16 step 32 bytes into the row. A tap is just a start address
//    at any row (TMA and wgmma both swizzle by the address's own bits); x
//    is fetched once per chunk for all 27 taps, and TMA's zero fill of
//    out-of-volume coordinates is the SAME padding;
//  * B, the weight, is one 64-column tile (one tap of one chunk) a ring
//    stage, loaded with the 128-byte swizzle that wgmma reads conflict-free;
//    a consumer releases a stage as soon as the wgmma group that read it has
//    completed, keeping one group in flight;
//  * tiles: BN = 128 output channels over 2x8x8 voxels (each of two
//    consumer warpgroups one z-plane, m64n128k16), or BN = 64 (Co not a
//    multiple of 128) over 4x8x8 (two z-planes a warpgroup, m64n64k16);
//  * Ci = 8 (the padded input conv): one 8-channel box (16-byte rows, no
//    swizzle), K = 216 as four 64-column weight tiles; a k16 step covers two
//    taps, the second tap's 8 channels one halo offset away (the
//    descriptor's LBO).

#include <algorithm>
#include <mutex>

#include "hopper.cuh"

namespace {

constexpr int TY = 8, TX = 8;  // output tile rows; z extent 2 * MZ
constexpr int HY = TY + 2, HX = TX + 2;
constexpr int CHUNK = 64;      // channels per halo load
constexpr int CONSUMERS = 256;  // 2 consumer warpgroups
constexpr int THREADS = 384;    // + 1 producer warpgroup: a weight thread and a halo thread
constexpr int WEIGHT_THREAD = 256, HALO_THREAD = 288;
constexpr int HALOS = 2;         // halo buffers
constexpr int CHAIN_CHUNKS = 4;  // chunks, whole or in part, a tensor-core chain spans: at most 4 * 27 taps * 4 k16 = 432 steps
constexpr int SMALL_STEPS = 16;  // k16 steps of the Ci = 8 conv: 4 weight tiles of 4
constexpr int MAX_CLUSTER = 8;   // splits of one tile, the blocks of one cluster (portable size)

// MZ z-planes a warpgroup (a tile of 2*MZ x 8 x 8 voxels). PERSIST:
// persistent blocks (no split) with a 4-stage weight ring and the rounded
// tile staged for its TMA store; else split K: one tile a block, no staging,
// the ring as deep as shared memory allows (at most 9 stages: a split block
// streams each weight tile for one tile's voxels, so its bytes in flight
// set its rate)
template <int BN, int MZ_, bool PERSIST>
struct Cfg {
  static constexpr int MZ = MZ_;
  static constexpr int TZ = 2 * MZ, HZ = TZ + 2;
  static constexpr int VOX = TZ * TY * TX;        // output voxels a tile
  static constexpr int ROWS = HZ * HY * HX;  // halo voxels
  static constexpr int SLAB = ROWS * 16;      // Ci = 8: the halo, one 16-byte row a voxel
  static constexpr int HALO = ROWS * 128;     // else: one 128-byte row (64 channels) a voxel
  static constexpr int B_BYTES = BN * 128;  // a 64-column weight tile
  static constexpr int FIT = (232448 - 1024 - HALOS * (HALO + 16)) / (B_BYTES + 16);
  static constexpr int STAGES = PERSIST ? 4 : FIT < 9 ? FIT : 9;  // weight ring
  static constexpr int HALO_OFF = STAGES * B_BYTES;
  static constexpr int OUT_OFF = HALO_OFF + HALOS * HALO;  // the rounded tile: BN/64 boxes of VOX 128-byte rows
  static constexpr int BAR_OFF = OUT_OFF + (PERSIST ? VOX * BN * 2 : 0);
  static constexpr int SMEM = BAR_OFF + 8 * (2 * STAGES + 2 * HALOS) + 1024;  // + alignment slack
  // split K: a block's fp32 partial tile, (MZ * BN / 8 column groups) x 256
  // consumer threads x 4 values, over the halo buffers once they are done
  static constexpr int GROUPS = MZ * BN / 8;
  static_assert(GROUPS * CONSUMERS * 16 <= HALOS * HALO, "the partial tile fits over the halo buffers");
  static_assert(SMEM <= 232448, "one block an SM");
};

struct FwdArgs {
  const float* bias;
  void* out;  // T (bf16 or f16): split-K clusters store it directly, whole tiles by TMA
  int D, H, W, Ci, Co, relu;
  int tiles_z, tiles_y, tiles_x, co_blocks, items;
  int k_tiles_per_split;  // of K's 64-column weight tiles (4 k16 steps each)
};

// A work item: one tile of output voxels and BN output channels.
struct Tile {
  int n, z0, y0, x0, n0;
};

template <int BN, int TZ>
__device__ __forceinline__ Tile tile_of(int item, const FwdArgs& a) {
  Tile t;
  t.n0 = (item % a.co_blocks) * BN;  // the co blocks of one voxel tile run side by side
  int r = item / a.co_blocks;
  t.x0 = (r % a.tiles_x) * TX;
  r /= a.tiles_x;
  t.y0 = (r % a.tiles_y) * TY;
  r /= a.tiles_y;
  t.z0 = (r % a.tiles_z) * TZ;
  t.n = r / a.tiles_z;
  return t;
}

// Halo row of output voxel (z-plane z, y 0, x 0) of the tile for tap `tap`.
__device__ __forceinline__ int halo_row(int z, int tap) {
  return ((z + tap / 9) * HY + (tap / 3) % 3) * HX + tap % 3;
}

// Two fp32 values rounded to nearest even as one pair of T (bf16 or f16), as 32 bits.
template <typename T>
__device__ __forceinline__ uint32_t pack_rounded(float v0, float v1) {
  if constexpr (std::is_same<T, f16>::value) {
    const __half2 h = __floats2half2_rn(v0, v1);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

// fp32 acc + fp32 bias of output channel col, col + 1, then ReLU.
__device__ __forceinline__ void bias_relu(float& v0, float& v1, int col, const float* bias, int relu) {
  if (bias) {
    v0 += bias[col];
    v1 += bias[col + 1];
  }
  if (relu) {
    v0 = fmaxf(v0, 0.f);
    v1 = fmaxf(v1, 0.f);
  }
}

template <int BN, typename T>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 64)
    wgmma_m64n64k16<0, 0, T>(d, da, db);
  else
    wgmma_m64n128k16<0, 0, T>(d, da, db);
}

// SMALL: Ci == 8 (one slab, two taps per k16 step); else Ci % 64 == 0.
// CUT: a split's slice spans more than CHAIN_CHUNKS chunks (fp32 running totals).
// PERSIST (gridDim.z == 1): persistent blocks walk items blockIdx.x, +
// gridDim.x, ...; else one item a block, the gridDim.z blocks of an item one
// cluster. T: the element type of x, the weight and out (bf16 or f16).
template <int BN, int MZ_, bool SMALL, bool CUT, bool PERSIST, typename T>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3x3_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap omap, const FwdArgs a) {
  using C = Cfg<BN, MZ_, PERSIST>;
  constexpr int MZ = C::MZ, STAGES = C::STAGES;
  constexpr int STEPS = SMALL ? 4 : 27;  // weight tiles per chunk

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzled tiles want 1024
  const uint32_t b_smem = base, bar = base + C::BAR_OFF;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (STAGES + s); };
  auto halo = [&](int h) { return base + C::HALO_OFF + h * C::HALO; };
  auto halo_full = [&](int h) { return bar + 8 * (2 * STAGES + h); };
  auto halo_empty = [&](int h) { return bar + 8 * (2 * STAGES + HALOS + h); };

  const int tid = threadIdx.x;
  if (tid == WEIGHT_THREAD) {
    prefetch_tensormap(&wmap);
  } else if (tid == HALO_THREAD) {
    prefetch_tensormap(&xmap);
    prefetch_tensormap(&omap);
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    for (int h = 0; h < HALOS; ++h) {
      mbar_init(halo_full(h), 1);
      mbar_init(halo_empty(h), 2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // K as 64-column weight tiles u = c * STEPS + st (chunk c, tap or tap
  // pair st); this block's slice [u_begin, u_end) covers chunks c_first..c_last
  const int splits = gridDim.z;
  const int u_begin = blockIdx.z * a.k_tiles_per_split;
  const int u_end = min((SMALL ? 1 : a.Ci / CHUNK) * STEPS, u_begin + a.k_tiles_per_split);
  const int c_first = u_begin / STEPS, c_last = (u_end - 1) / STEPS;
  auto wcol = [&](int st, int c) { return SMALL ? st * 64 : st * a.Ci + c * CHUNK; };

  if (tid >= CONSUMERS) {  // producer warpgroup: two threads issue every TMA load
    setmaxnreg_dec<40>();
    if (tid == WEIGHT_THREAD) {
      int s = 0;
      uint32_t ph = 0;
      for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
        const int n0 = (item % a.co_blocks) * BN;
        for (int u = u_begin; u < u_end; ++u) {
          mbar_wait(empty(s), ph ^ 1);
          mbar_expect_tx(full(s), C::B_BYTES);
          tma_load_2d(b_smem + s * C::B_BYTES, &wmap, full(s), wcol(u % STEPS, u / STEPS), n0);
          if (++s == STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    } else if (tid == HALO_THREAD) {
      int seq = 0;  // chunks loaded: chunk seq goes to buffer seq % HALOS
      for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
        const Tile t = tile_of<BN, C::TZ>(item, a);
        for (int c = c_first; c <= c_last; ++c, ++seq) {
          const int hb = seq % HALOS;
          mbar_wait(halo_empty(hb), ((seq / HALOS) & 1) ^ 1);
          mbar_expect_tx(halo_full(hb), SMALL ? C::SLAB : C::HALO);
          tma_load_5d(halo(hb), &xmap, halo_full(hb), c * CHUNK, t.x0 - 1, t.y0 - 1, t.z0 - 1, t.n);
        }
      }
    }
    if constexpr (!PERSIST) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // consumers: warpgroup wg computes z-planes wg * MZ + m of each tile
  setmaxnreg_inc<232>();
  const int wg = tid >> 7, lane = tid & 31, warp = (tid >> 5) & 3;
  // PERSIST: two accumulator sets, so that a tile's epilogue runs behind
  // the next tile's first wgmma groups
  float acc[PERSIST ? 2 : 1][MZ][BN / 2];
  float total[CUT ? MZ : 1][CUT ? BN / 2 : 1];  // CUT: the running totals of the finished chains
  int s = 0, seq = 0;
  uint32_t ph = 0;

  // The rounded tile into shared memory as BN/64 boxes of VOX rows of 64
  // channels (128-byte swizzle: the 16-byte chunk index XOR the row's low 3
  // bits, so a warp's writes fall in distinct banks), then one TMA store a
  // box, which runs on while the next tile computes.
  auto store_tile = [&](float (&d)[MZ][BN / 2], const Tile& t) {
    const uint32_t stage = base + C::OUT_OFF;
    if (tid == 0) bulk_wait_read<0>();  // the last tile's stores are done reading
    named_barrier(1, CONSUMERS);
#pragma unroll
    for (int m = 0; m < MZ; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = (wg * MZ + m) * TY * TX + warp * 16 + (lane >> 2) + h * 8;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = 8 * j + 2 * (lane & 3);
          float v0 = d[m][4 * j + 2 * h], v1 = d[m][4 * j + 2 * h + 1];
          if (t.n0 + col < a.Co) bias_relu(v0, v1, t.n0 + col, a.bias, a.relu);
          st_shared_u32(stage + (j / 8) * (C::VOX * 128) + v * 128 + (((j % 8) ^ (v & 7)) << 4) + 4 * (lane & 3),
                        pack_rounded<T>(v0, v1));
        }
      }
    }
    fence_proxy_async();
    named_barrier(1, CONSUMERS);
    if (tid == 0) {
      for (int b = 0; b < BN / 64 && t.n0 + 64 * b < a.Co; ++b)
        tma_store_5d(&omap, stage + b * (C::VOX * 128), t.n0 + 64 * b, t.x0, t.y0, t.z0, t.n);
      bulk_commit();
    }
  };

  // Tile t's K slice into d; with `store`, the previous tile pt (in dp) is
  // stored once the first two weight stages' wgmma are queued.
  auto run = [&](float (&d)[MZ][BN / 2], float (&dp)[MZ][BN / 2], const Tile& pt, bool store) {
#pragma unroll
    for (int m = 0; m < MZ; ++m) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        d[m][i] = 0.f;
        if constexpr (CUT) total[m][i] = 0.f;
      }
      fence_regs(d[m]);
    }
    for (int c = c_first; c <= c_last; ++c, ++seq) {
      if constexpr (CUT) {
        // a chain ends after CHAIN_CHUNKS of the slice's chunks, whole or
        // in part (its wgmma are done): into the totals
        if (c > c_first && (c - c_first) % CHAIN_CHUNKS == 0) {
#pragma unroll
          for (int m = 0; m < MZ; ++m) {
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) {
              total[m][i] += d[m][i];
              d[m][i] = 0.f;
            }
            fence_regs(d[m]);
          }
        }
      }
      const int hb = seq % HALOS;
      mbar_wait(halo_full(hb), (seq / HALOS) & 1);
      const uint32_t hs = halo(hb);
      int prev = -1;
      // a persistent block sums every weight tile of every chunk
      const int st_begin = PERSIST ? 0 : max(0, u_begin - c * STEPS);
      const int st_end = PERSIST ? STEPS : min(STEPS, u_end - c * STEPS);
      for (int st = st_begin; st < st_end; ++st) {
        mbar_wait(full(s), ph);
        wgmma_fence();
        const uint32_t bs = b_smem + s * C::B_BYTES;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint64_t db = gmma_desc(bs + 32 * j, 16, 1024, LAYOUT_B128);
#pragma unroll
          for (int m = 0; m < MZ; ++m) {
            const int z = wg * MZ + m;
            uint64_t da;
            if constexpr (SMALL) {
              // taps t0 and t0 + 1. The weight's K past 216 reads as zero, so
              // a tap past 26 re-reads tap 26's (finite) channels: no branch
              // around the wgmma, which would serialize the warpgroup's issue
              const int t0 = min(st * 8 + 2 * j, 26);
              const int r0 = halo_row(z, t0);
              const uint32_t lbo = t0 + 1 < 27 ? (halo_row(z, t0 + 1) - r0) * 16 : 0;
              da = gmma_desc(hs + r0 * 16, lbo, HX * 16, LAYOUT_INTERLEAVE);
            } else {
              // 128-byte swizzled rows: the tap's first row r, k16 step j
              // 32 bytes into it, 8-row groups (y) HX rows apart
              const int r = halo_row(z, st);
              da = gmma_desc_rows(hs + r * 128 + 32 * j, HX * 128);
            }
            wgmma_bn<BN, T>(d[m], da, db);
          }
        }
        wgmma_commit();
        if constexpr (PERSIST) {
          if (store && c == 0 && st == 1) {
#pragma unroll
            for (int m = 0; m < MZ; ++m) fence_regs(dp[m]);
            store_tile(dp, pt);
          }
        }
        wgmma_wait<1>();  // the previous stage's group is done reading its tiles
        if (prev >= 0 && (tid & 127) == 0) mbar_arrive(empty(prev));
        prev = s;
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();  // every read of this chunk's halo is done
      if ((tid & 127) == 0) {
        mbar_arrive(empty(prev));
        mbar_arrive(halo_empty(hb));
      }
    }
#pragma unroll
    for (int m = 0; m < MZ; ++m) {
      fence_regs(d[m]);
      if constexpr (CUT) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) d[m][i] = total[m][i] + d[m][i];
      }
    }
  };

  if constexpr (PERSIST) {
    // items blockIdx.x, + gridDim.x, ... alternately into acc[0] and acc[1];
    // each tile stored while the next one's first wgmma run (the last alone)
    Tile pt{};
    bool pending = false;
    for (int item = blockIdx.x;; item += 2 * gridDim.x) {
      if (item >= a.items) {
        if (pending) store_tile(acc[1], pt);
        break;
      }
      const Tile t0 = tile_of<BN, C::TZ>(item, a);
      run(acc[0], acc[1], pt, pending);
      pt = t0;
      if (item + gridDim.x >= a.items) {
        store_tile(acc[0], pt);
        break;
      }
      const Tile t1 = tile_of<BN, C::TZ>(item + gridDim.x, a);
      run(acc[1], acc[0], pt, true);
      pt = t1;
      pending = true;
    }
    if (tid == 0) bulk_wait_read<0>();
  } else {
    // Split K (one item a block): the partial into shared memory, then this
    // block's slice of the tile, column groups [g0, g1), summed over the
    // cluster's blocks in rank order (rank = blockIdx.z)
    const Tile t = tile_of<BN, C::TZ>(blockIdx.x, a);
    run(acc[0], acc[0], t, false);
    const uint32_t part = base + C::HALO_OFF;
    named_barrier(1, CONSUMERS);  // both warpgroups are done reading the halo buffers
#pragma unroll
    for (int m = 0; m < MZ; ++m) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        st_shared_f4(part + ((m * (BN / 8) + j) * CONSUMERS + tid) * 16, acc[0][m][4 * j], acc[0][m][4 * j + 1],
                     acc[0][m][4 * j + 2], acc[0][m][4 * j + 3]);
    }
    cluster_sync();
    const int rank = blockIdx.z;
    const int g0 = rank * C::GROUPS / splits, g1 = (rank + 1) * C::GROUPS / splits;
    T* out = static_cast<T*>(a.out);
    for (int g = g0; g < g1; ++g) {
      const uint32_t addr = part + (g * CONSUMERS + tid) * 16;
      float4 p[MAX_CLUSTER];  // every peer's partial in flight at once, then summed in rank order
#pragma unroll
      for (int k = 0; k < MAX_CLUSTER; ++k)
        if (k < splits) p[k] = ld_cluster_f4(cluster_map(addr, k));
      float4 sum = p[0];
#pragma unroll
      for (int k = 1; k < MAX_CLUSTER; ++k) {
        if (k < splits) {
          sum.x += p[k].x;
          sum.y += p[k].y;
          sum.z += p[k].z;
          sum.w += p[k].w;
        }
      }
      const int m = g / (BN / 8), j = g % (BN / 8);
      const int z = t.z0 + wg * MZ + m, col = t.n0 + 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + (lane >> 2) + h * 8;
        const int y = t.y0 + r / TX, x = t.x0 + r % TX;
        if (z >= a.D || y >= a.H || x >= a.W || col >= a.Co) continue;
        float v0 = h ? sum.z : sum.x, v1 = h ? sum.w : sum.y;
        bias_relu(v0, v1, col, a.bias, a.relu);
        const long long v = ((static_cast<long long>(t.n) * a.D + z) * a.H + y) * a.W + x;
        *reinterpret_cast<uint32_t*>(out + v * a.Co + col) = pack_rounded<T>(v0, v1);
      }
    }
    cluster_sync();  // the peers are done reading this block's partial
  }
}

// ---- launch plan -------------------------------------------------------------

struct Plan {
  bool small, cut;
  int bn, mz, tz;
  int tiles_z, tiles_y, tiles_x, co_blocks, items;
  int splits, k_tiles_per_split, chain_steps;
  int grid_x;
  int stages, smem;
};

// A plan's estimated time, in weight tiles a block sums (27 to a 64-channel
// chunk): the rounds it runs in (the tiles over the blocks the card holds
// at once: one persistent block an SM, or `clusters[splits - 1]` whole
// clusters) times a block's weight tiles, plus CLUSTER_COST for a split
// block's own fill, cluster barriers and sum (on an H100 80GB HBM3, B1's
// split blocks at 8^3-32^3 took 8-13 us beyond their 9.2-11 us a chunk:
// tools/ablate_conv3x3x3.py --deep, splits). -1: the card holds no such
// cluster.
constexpr int CLUSTER_COST = 24;
long long plan_cost(long long items, int splits, int per, int sms, const int* clusters) {
  const long long resident = splits == 1 ? sms : clusters[splits - 1];
  if (resident <= 0) return -1;
  return (items + resident - 1) / resident * (per + (splits == 1 ? 0 : CLUSTER_COST));
}

template <int BN, int MZ, bool PERSIST>
void set_config(Plan& p) {
  p.stages = Cfg<BN, MZ, PERSIST>::STAGES;
  p.smem = Cfg<BN, MZ, PERSIST>::SMEM;
}

// BN = 128 output channels over 2x8x8 voxels, or 64 over 4x8x8 where Co is
// not a multiple of 128. K's weight tiles are split into equal slices (the
// last shorter), as many as the least plan_cost asks (ties to fewer; the
// Ci = 8 conv never splits); a slice longer than one chain (CHAIN_CHUNKS
// chunks' weight tiles) cuts its chains in the block (CUT). Block 0's slice
// starts a chunk, so its first chain is the longest there is.
// clusters[k - 1]: the clusters of k split blocks the card holds at once
// (max_clusters).
Plan make_plan(int N, int D, int H, int W, int Ci, int Co, int sms, const int* clusters) {
  Plan p{};
  p.small = Ci == 8;
  p.bn = Co % 128 == 0 ? 128 : 64;
  p.mz = p.bn == 64 ? 2 : 1;
  p.tz = 2 * p.mz;
  p.tiles_z = (D + p.tz - 1) / p.tz;
  p.tiles_y = (H + TY - 1) / TY;
  p.tiles_x = (W + TX - 1) / TX;
  p.co_blocks = (Co + p.bn - 1) / p.bn;
  const long long items = static_cast<long long>(N) * p.tiles_z * p.tiles_y * p.tiles_x * p.co_blocks;
  p.items = static_cast<int>(std::min<long long>(items, 0x7fffffff));
  const int units = p.small ? SMALL_STEPS / 4 : Ci / CHUNK * 27;  // K's 64-column weight tiles
  long long best = -1;
  for (int s = 1; s <= (p.small ? 1 : MAX_CLUSTER); ++s) {
    const int per = (units + s - 1) / s, splits = (units + per - 1) / per;  // splits <= s
    const long long cost = plan_cost(items, splits, per, sms, clusters);
    if (cost >= 0 && (best < 0 || cost < best)) {
      best = cost;
      p.splits = splits;
      p.k_tiles_per_split = per;
    }
  }
  p.cut = p.k_tiles_per_split > CHAIN_CHUNKS * 27;
  p.chain_steps = 4 * std::min(p.k_tiles_per_split, CHAIN_CHUNKS * 27);
  p.grid_x = p.splits > 1 ? p.items : std::min(p.items, sms);
  if (p.bn == 64)
    p.splits > 1 ? set_config<64, 2, false>(p) : set_config<64, 2, true>(p);
  else
    p.splits > 1 ? set_config<128, 1, false>(p) : set_config<128, 1, true>(p);
  return p;
}

template <int BN, int MZ, bool SMALL, bool CUT, bool PERSIST, typename T>
cudaError_t launch(const Plan& p, const CUtensorMap& xmap, const CUtensorMap& wmap, const CUtensorMap& omap,
                   const FwdArgs& a, cudaStream_t stream) {
  auto kernel = conv3x3x3_kernel<BN, MZ, SMALL, CUT, PERSIST, T>;
  using C = Cfg<BN, MZ, PERSIST>;
  cudaError_t err = set_smem(kernel, C::SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.grid_x), 1, static_cast<unsigned>(p.splits));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = static_cast<unsigned>(p.splits);
  cfg.attrs = cluster;
  cfg.numAttrs = p.splits > 1 ? 1 : 0;
  void* args[] = {const_cast<CUtensorMap*>(&xmap), const_cast<CUtensorMap*>(&wmap), const_cast<CUtensorMap*>(&omap),
                  const_cast<FwdArgs*>(&a)};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The clusters of 1..MAX_CLUSTER blocks of the split kernel that `device`
// (current) holds at once, into out[0..MAX_CLUSTER): the H100's SMs sit in
// GPCs of 16-18, a cluster's blocks in one GPC, one block an SM (both BN
// configs take over half an SM's shared memory), so clusters of k fit fewer
// than SMs / k. Asked once a device (cudaOccupancyMaxActiveClusters); 0
// where the card cannot say.
constexpr int MAX_DEVICES = 64;
void max_clusters(int device, int* out) {
  static std::once_flag once[MAX_DEVICES];
  static int table[MAX_DEVICES][MAX_CLUSTER];
  auto query = [](int* t) {
    auto kernel = conv3x3x3_kernel<64, 2, false, false, false, bf16>;
    constexpr int smem = Cfg<64, 2, false>::SMEM;
    std::fill(t, t + MAX_CLUSTER, 0);
    for (int k = 1; k <= MAX_CLUSTER; ++k) {
      if (set_smem(kernel, smem) != cudaSuccess) break;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(1, 1, static_cast<unsigned>(k));
      cfg.blockDim = dim3(THREADS);
      cfg.dynamicSmemBytes = smem;
      cudaLaunchAttribute cluster[1];
      cluster[0].id = cudaLaunchAttributeClusterDimension;
      cluster[0].val.clusterDim.x = 1;
      cluster[0].val.clusterDim.y = 1;
      cluster[0].val.clusterDim.z = static_cast<unsigned>(k);
      cfg.attrs = cluster;
      cfg.numAttrs = 1;
      if (cudaOccupancyMaxActiveClusters(&t[k - 1], reinterpret_cast<const void*>(kernel), &cfg) != cudaSuccess)
        t[k - 1] = 0;
    }
    cudaGetLastError();  // a failed query leaves no error for the launch to report
  };
  if (device < 0 || device >= MAX_DEVICES) {
    query(out);
    return;
  }
  std::call_once(once[device], query, table[device]);
  std::copy(table[device], table[device] + MAX_CLUSTER, out);
}

// The Ci = 8 conv never splits (one chunk).
template <typename T>
cudaError_t dispatch(const Plan& p, const CUtensorMap& xmap, const CUtensorMap& wmap, const CUtensorMap& omap,
                     const FwdArgs& a, cudaStream_t s) {
  const bool split = p.splits > 1;
  if (p.bn == 64) {
    if (p.small) return launch<64, 2, true, false, true, T>(p, xmap, wmap, omap, a, s);
    if (p.cut)
      return split ? launch<64, 2, false, true, false, T>(p, xmap, wmap, omap, a, s)
                   : launch<64, 2, false, true, true, T>(p, xmap, wmap, omap, a, s);
    return split ? launch<64, 2, false, false, false, T>(p, xmap, wmap, omap, a, s)
                 : launch<64, 2, false, false, true, T>(p, xmap, wmap, omap, a, s);
  }
  if (p.small) return launch<128, 1, true, false, true, T>(p, xmap, wmap, omap, a, s);
  if (p.cut)
    return split ? launch<128, 1, false, true, false, T>(p, xmap, wmap, omap, a, s)
                 : launch<128, 1, false, true, true, T>(p, xmap, wmap, omap, a, s);
  return split ? launch<128, 1, false, false, false, T>(p, xmap, wmap, omap, a, s)
               : launch<128, 1, false, false, true, T>(p, xmap, wmap, omap, a, s);
}

// The launch of one conv in element type T (the entry points below).
template <typename T>
int run(const void* x, const void* w, const void* bias, void* out, int N, int D, int H, int W, int Ci, int Co,
        int relu, void* stream, int device) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!(Ci == 8 || Ci % CHUNK == 0) || Co % 8) return static_cast<int>(cudaErrorInvalidValue);
  int clusters[MAX_CLUSTER];
  max_clusters(device, clusters);
  const Plan p = make_plan(N, D, H, W, Ci, Co, sm_count(device), clusters);

  CUtensorMap xmap, wmap, omap;
  constexpr CUtensorMapDataType type = tensor_map_type<T>();
  err = make_ndhwc_map(&xmap, x, N, D, H, W, Ci, p.small ? 8 : CHUNK, HX, HY, p.tz + 2, !p.small, type);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(27) * Ci, static_cast<cuuint64_t>(Co)};
  const cuuint64_t wstride[1] = {static_cast<cuuint64_t>(27) * Ci * sizeof(T)};
  const cuuint32_t wbox[2] = {64, static_cast<cuuint32_t>(p.bn)};
  err = make_tensor_map(&wmap, w, 2, wdims, wstride, wbox, true, type);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = make_ndhwc_map(&omap, out, N, D, H, W, Co, 64, TX, TY, p.tz, true, type);
  if (err != cudaSuccess) return static_cast<int>(err);

  FwdArgs a;
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.D = D, a.H = H, a.W = W, a.Ci = Ci, a.Co = Co, a.relu = relu;
  a.tiles_z = p.tiles_z, a.tiles_y = p.tiles_y, a.tiles_x = p.tiles_x;
  a.co_blocks = p.co_blocks, a.items = p.items;
  a.k_tiles_per_split = p.k_tiles_per_split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch<T>(p, xmap, wmap, omap, a, s));
}

}  // namespace

extern "C" {

// The clusters of 1..8 split blocks that `device` holds at once, into
// out[0..8) (0 where the card cannot say); returns 8, or the cudaError_t of
// making the device current, negated.
int pcmseg_conv3x3x3_clusters(int device, int* out) {
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  max_clusters(device, out);
  return MAX_CLUSTER;
}

// The launch plan for x (N, D, H, W, Ci) into Co channels on a card of
// `sms` SMs that holds clusters[k - 1] clusters of k split blocks at once
// (pcmseg_conv3x3x3_clusters; conv3d.conv_plan is its mirror), the same for
// both element types, as PLAN_FIELDS numbers into out: BN (output channels a tile, the
// wgmma's N: m64nBNk16), the tile's z, y and x extent, the splits of K (the
// blocks of one cluster; 1: persistent blocks, no cluster), K's 64-column
// weight tiles a split (27 to a 64-channel chunk, 4 k16 steps each; the
// Ci = 8 conv has 4), the longest tensor-core chain in k16 steps, whether
// chains are added into running totals in the block (CUT), the blocks
// along x (gridDim.x), the work items (tiles x co blocks), the weight ring's
// stages, the dynamic shared memory a block and the device workspace in
// bytes (none).
constexpr int PLAN_FIELDS = 13;

int pcmseg_conv3x3x3_plan(int N, int D, int H, int W, int Ci, int Co, int sms, const int* clusters,
                          long long* out) {
  const Plan p = make_plan(N, D, H, W, Ci, Co, sms, clusters);
  const long long f[PLAN_FIELDS] = {p.bn, p.tz, TY, TX, p.splits, p.k_tiles_per_split, p.chain_steps, p.cut,
                                    p.grid_x, p.items, p.stages, p.smem, 0};
  for (int i = 0; i < PLAN_FIELDS; ++i) out[i] = f[i];
  return PLAN_FIELDS;
}

// Launch on `stream` (PyTorch's current stream) of device `device`. The caller
// checks shapes, dtypes, contiguity and 16-byte alignment, requires Ci == 8
// or Ci % 64 == 0 and Co % 8 == 0, and passes x, the (Co, 27*Ci) packed
// weight and out in bf16 (fp16 for the _f16 entry) and the fp32 bias or
// null. Returns the cudaError_t of the launch; does not synchronise.
int pcmseg_conv3x3x3_bf16(const void* x, const void* w, const void* bias, void* out, int N, int D, int H, int W,
                          int Ci, int Co, int relu, void* stream, int device) {
  return run<bf16>(x, w, bias, out, N, D, H, W, Ci, Co, relu, stream, device);
}

int pcmseg_conv3x3x3_f16(const void* x, const void* w, const void* bias, void* out, int N, int D, int H, int W,
                         int Ci, int Co, int relu, void* stream, int device) {
  return run<f16>(x, w, bias, out, N, D, H, W, Ci, Co, relu, stream, device);
}

const char* pcmseg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
