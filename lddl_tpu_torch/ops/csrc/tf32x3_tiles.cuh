// The 3xTF32 building blocks of the fp32 attention kernels on the tensor
// cores (attention_f32_fwd.cu, attention_f32_bwd.cu): how a body divides
// its work and its shared memory (Plan, Smem), the producer thread and its
// landing ring, the tf32 split of an item's rows and of each landed tile,
// the score products (both operands from shared memory), the contracting
// products (A from registers), a score tile's elements as A fragments, the
// threads' fp32 sum of per-tile partial products, and the store of an
// accumulator chunk; and the pieces of the wide (D=256) bodies of
// attention_f32_fwd.cu and attention_f32_bwd.cu, whose item is kept in
// fp32 alone (see "wide bodies" below).
//
// 3xTF32: a TF32 product rounds each operand to a 10-bit mantissa, so
// every operand x is split as hi = tf32(x), lo = tf32(x - hi) (cvt.rna;
// |x - hi - lo| <= 2^-22 |x|) and a product a b is taken as
// lo_a hi_b + hi_a lo_b + hi_a hi_b, three wgmma into one fp32 accumulator,
// the two small terms first; lo_a lo_b (<= 2^-22 relative) is dropped.
//
// A body: a block of NWG consumer warpgroups and a producer warpgroup
// works on items of 64 NWG rows of one (batch*head), its own rows (ROPS
// operands: Q, or Q and dO, or K and V). The producer's one thread loads
// an item's rows by TMA into the item buffer, and streams the other side
// (two operands) in TR-row tiles with their row slices (mask, LSE, delta)
// through a ring of landing stages guarded by full/empty mbarriers. tf32
// wgmma reads both operands K-major, so a product that contracts over the
// streamed rows needs the streamed tile transposed:
// - each consumer warpgroup splits its own rows of the item in place (hi
//   over the fp32, lo beside it) once an item;
// - all consumers split each landed tile into one split buffer: hi and lo
//   in the landed (natural) layout for the score products (streamed
//   operands [0, NNAT)), and hi and lo transposed (rows = D) for the
//   contracting products (operands [T0, T0 + NT)), then free the landing
//   stage, so the producer's next loads overlap the products;
// - each warpgroup computes its 64 x TR score tiles with wgmma m64nTRk8
//   (both operands from shared memory) into registers, works on them
//   there, splits them in registers and feeds them to the contracting
//   product as the register A operand (m64n64k8 over 64-column chunks of
//   D): no score tile passes through shared memory.
// The A fragment of a k8 step holds columns t and t + 4 of a row where the
// score accumulator holds columns 2t and 2t + 1; the split pass writes
// the transposed tile's K columns in the order 0 2 4 6 1 3 5 7 within each
// group of 8, so that the accumulator's pairs are the fragment as they
// stand (the k order of a product's sum is free). A tile's contracting
// product starts from zero and the threads add it to the running sum: the
// tensor core's fp32 sums truncate, and over the hundreds of k steps of a
// long row their error grows past 1e-5 of the result.
// Every kernel runs a persistent grid of at most one block per SM; a block
// walks the items blockIdx.x, blockIdx.x + gridDim.x, ...; the landing
// ring runs on across items.

#pragma once

#include "hopper_tiles.cuh"

namespace lddl_tf32x3 {

using namespace lddl_hopper;

constexpr int CONSUMER_REGS = 240;
constexpr int PRODUCER_REGS = 24;
constexpr float NEG_BIG = -1e9f;

// How a body divides its work and its shared memory at head dim D: NWG
// consumer warpgroups, streamed tiles of TR rows, ROPS operands of an
// item, the streamed operands [0, NNAT) kept natural and [T0, T0 + NT)
// transposed, SLICES row slices a tile. A tile's hi/lo pair takes twice
// its fp32 bytes; the bodies' headers give their sizes.
template <int D_, int NWG_, int TR_, int ROPS_, int NNAT_, int T0_, int NT_,
          int SLICES_>
struct Plan {
  static_assert(D_ == 64 || D_ == 128, "built at D=64 and 128");
  static constexpr int D = D_;
  static constexpr int NWG = NWG_;                 // consumer warpgroups
  static constexpr int NC = 128 * NWG;             // consumer threads
  static constexpr int NTHREADS = NC + 128;        // + the producer's
  static constexpr int IROWS = 64 * NWG;           // rows of a work item
  static constexpr int TR = TR_;                   // rows of a streamed tile
  static constexpr int DP = D / PANEL_F32;         // panels of a D-wide row
  static constexpr int NCH = D / 64;               // 64-column output chunks
  static constexpr int ROPS = ROPS_;               // operands of an item
  static constexpr int NNAT = NNAT_;               // tiles kept natural
  static constexpr int T0 = T0_;                   // first tile transposed
  static constexpr int NT = NT_;                   // tiles transposed
  static constexpr int SLICES = SLICES_;           // row slices a tile
  static constexpr int SLICE = TR * 4;             // bytes of a slice
  static constexpr int RES_P = IROWS * ROW_BYTES;  // an item buffer panel
  static constexpr int ITEM_OP = 2 * DP * RES_P;   // an item operand, hi + lo
  static constexpr int TILE_P = TR * ROW_BYTES;    // a streamed panel
  static constexpr int TPOSE_P = D * ROW_BYTES;    // a transposed panel
  static constexpr int TPN = 2 * TR / PANEL_F32;   // its panels: hi, lo cols
  static constexpr int LS = 2;                     // landing stages
  // The item buffer (ROPS operands, hi and lo), the split tile (NNAT
  // operands hi and lo; NT of them transposed), the landing stages (two
  // raw tiles), the row slices (the stages' and the split tile's copy),
  // the barriers, and room to align the base to 1024 bytes.
  static constexpr int RES = 2 * ROPS * DP * RES_P;
  static constexpr int NAT = 2 * NNAT * DP * TILE_P;
  static constexpr int TPOSE = NT * TPN * TPOSE_P;
  static constexpr int LAND = 2 * DP * TILE_P;
  static constexpr size_t SMEM = RES + NAT + TPOSE + LS * LAND +
                                 (LS + 1) * SLICES * SLICE +
                                 (2 * LS + 2) * 8 + 1024;
  static_assert(SMEM <= 232448, "227 KB of shared memory");
};

__device__ __forceinline__ float bias(int km, int qm) {
  return (km > 0 && km == qm) ? 0.0f : NEG_BIG;
}

// Shared memory of a body, carved from the dynamic allocation.
template <typename P>
struct Smem {
  uint8_t* res;     // operand o, half h (0 hi, 1 lo): + (2o + h) DP RES_P
  uint8_t* nat;     // the split tile, natural: + (2o + h) DP TILE_P
  uint8_t* tpose;   // transposed operand o: + (o - T0) TPN TPOSE_P
  uint8_t* land;    // stage s: + s LAND, operand o: + o DP TILE_P
  uint8_t* slices;  // stage s: + s SLICES SLICE; the split tile's at LS
  uint64_t* full;
  uint64_t* empty;
  uint64_t* res_full;
  uint64_t* res_empty;

  // base: the dynamic shared memory aligned to 1024 bytes.
  __device__ __forceinline__ explicit Smem(uint8_t* base) {
    res = base;
    nat = res + P::RES;
    tpose = nat + P::NAT;
    land = tpose + P::TPOSE;
    slices = land + P::LS * P::LAND;
    full = reinterpret_cast<uint64_t*>(slices +
                                       (P::LS + 1) * P::SLICES * P::SLICE);
    empty = full + P::LS;
    res_full = empty + P::LS;
    res_empty = res_full + 1;
  }
};

// Thread 0 initialises the ring's and the item buffer's barriers; the
// block then meets.
template <typename P>
__device__ __forceinline__ void init_barriers(const Smem<P>& sm) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::LS; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], P::NC);
    }
    mbar_init(sm.res_full, 1);
    mbar_init(sm.res_empty, P::NC);
    mbar_fence_init();
  }
  __syncthreads();
}

// The producer thread: per item, the item's own rows of operand `ra` (and
// `rb` where ROPS is 2, ITEM_OP bytes on) once (into the hi halves of the
// item buffer, or the fp32 item of a wide plan, once the last item's
// consumers are done with it), then the tiles of `sa` and
// `sb` and their row slices through the landing ring. `slice_src` gives a
// tile's slices (b, the tile's first row (bh * L + i * TR), its first
// column i * TR, the stage's slices, the stage's barrier).
template <typename P, typename SliceFn>
__device__ __forceinline__ void produce(const Smem<P>& sm,
                                        const CUtensorMap* ra,
                                        const CUtensorMap* rb,
                                        const CUtensorMap* sa,
                                        const CUtensorMap* sb, int BH,
                                        int L, int H, SliceFn slice_src) {
  constexpr int DP = P::DP, TR = P::TR;
  const int nblk = L / P::IROWS, nitems = BH * nblk, ntiles = L / TR;
  int t = 0;
  for (int item = blockIdx.x, j = 0; item < nitems;
       item += gridDim.x, ++j) {
    const int bh = item / nblk, r0 = (item % nblk) * P::IROWS, b = bh / H;
    const int row0 = bh * L;
    mbar_wait(sm.res_empty, (j & 1) ^ 1);
    mbar_arrive_expect_tx(sm.res_full, P::ROPS * DP * P::RES_P);
    for (int p = 0; p < DP; ++p)
      for (int h = 0; h < P::IROWS / TR; ++h) {
        tma_load_2d(sm.res + p * P::RES_P + h * P::TILE_P, ra,
                    p * PANEL_F32, row0 + r0 + h * TR, sm.res_full);
        if constexpr (P::ROPS == 2)
          tma_load_2d(sm.res + P::ITEM_OP + p * P::RES_P + h * P::TILE_P, rb,
                      p * PANEL_F32, row0 + r0 + h * TR, sm.res_full);
      }
    for (int i = 0; i < ntiles; ++i, ++t) {
      const int s = t % P::LS;
      mbar_wait(&sm.empty[s], ((t / P::LS) & 1) ^ 1);
      uint8_t* st = sm.land + s * P::LAND;
      mbar_arrive_expect_tx(&sm.full[s],
                            P::LAND + P::SLICES * P::SLICE);
      for (int p = 0; p < DP; ++p) {
        tma_load_2d(st + p * P::TILE_P, sa, p * PANEL_F32, row0 + i * TR,
                    &sm.full[s]);
        tma_load_2d(st + (DP + p) * P::TILE_P, sb, p * PANEL_F32,
                    row0 + i * TR, &sm.full[s]);
      }
      slice_src(b, row0 + i * TR, i * TR,
                sm.slices + s * P::SLICES * P::SLICE, &sm.full[s]);
    }
  }
}

// A warpgroup splits its 64 rows of the item buffer in place: hi over the
// fp32 values, lo at the same place of the lo half (elementwise, so the
// swizzle needs no undoing).
template <typename P>
__device__ __forceinline__ void split_item(const Smem<P>& sm, int wg,
                                           int wtid) {
  constexpr int SLOTS = 64 * ROW_BYTES / 16;   // a panel's rows of the wg
#pragma unroll 1
  for (int o = 0; o < P::ROPS; ++o)
#pragma unroll 1
    for (int p = 0; p < P::DP; ++p) {
      uint8_t* hi = sm.res + (2 * o * P::DP + p) * P::RES_P +
                    wg * 64 * ROW_BYTES;
#pragma unroll 4
      for (int i = wtid; i < SLOTS; i += 128) {
        const float4 x = *reinterpret_cast<const float4*>(hi + 16 * i);
        uint4 h, l;
        split_tf32(x.x, h.x, l.x);
        split_tf32(x.y, h.y, l.y);
        split_tf32(x.z, h.z, l.z);
        split_tf32(x.w, h.w, l.w);
        *reinterpret_cast<uint4*>(hi + 16 * i) = h;
        *reinterpret_cast<uint4*>(hi + P::DP * P::RES_P + 16 * i) = l;
      }
    }
}

// The 16-byte chunk of split task `task` in a landing stage: a task is
// one chunk of a landed tile (row, column chunk ch, panel p, operand o);
// the 32 lanes of a warp take 32 rows (or 16 rows of two chunks) of one
// column chunk.
template <typename P>
__device__ __forceinline__ int task_slot(int task) {
  constexpr int TR = P::TR, DP = P::DP;
  const int row = task % TR, ch = (task / TR) % 8;
  const int p = (task / (8 * TR)) % DP, o = task / (8 * TR * DP);
  return (o * DP + p) * P::TILE_P + row * ROW_BYTES + ((ch ^ (row % 8)) * 16);
}

// Split task `task`'s chunk x into the split tile: the natural operands'
// hi and lo in the landed layout, the transposed ones' (row n = column n
// of the tile; hi in K columns [0, TR), lo in [TR, 2 TR), each group of 8
// tile rows in the order 0 2 4 6 1 3 5 7). The transposed stores of a
// warp hit 32 banks.
template <typename P>
__device__ __forceinline__ void split_task(const Smem<P>& sm, int task,
                                           const float4& x) {
  constexpr int DP = P::DP, TR = P::TR;
  const int row = task % TR, ch = (task / TR) % 8;
  const int p = (task / (8 * TR)) % DP, o = task / (8 * TR * DP);
  uint32_t h[4], l[4];
  split_tf32(x.x, h[0], l[0]);
  split_tf32(x.y, h[1], l[1]);
  split_tf32(x.z, h[2], l[2]);
  split_tf32(x.w, h[3], l[3]);
  if (P::NNAT == 2 || o < P::NNAT) {
    uint8_t* nat = sm.nat + o * DP * P::TILE_P + task_slot<P>(task);
    *reinterpret_cast<uint4*>(nat) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(nat + DP * P::TILE_P) =
        make_uint4(l[0], l[1], l[2], l[3]);
  }
  if ((P::T0 == 0 || o >= P::T0) && o < P::T0 + P::NT) {
    const int kl = 8 * (row / 8) + 4 * (row % 2) + (row % 8) / 2;
    uint8_t* tp = sm.tpose + (o - P::T0) * P::TPN * P::TPOSE_P;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = p * PANEL_F32 + 4 * ch + e;
      const int chi = kl, clo = TR + kl;
      *reinterpret_cast<uint32_t*>(
          tp + (chi / 32) * P::TPOSE_P + n * ROW_BYTES +
          ((((chi % 32) / 4) ^ (n % 8)) * 16) + (chi % 4) * 4) = h[e];
      *reinterpret_cast<uint32_t*>(
          tp + (clo / 32) * P::TPOSE_P + n * ROW_BYTES +
          ((((clo % 32) / 4) ^ (n % 8)) * 16) + (clo % 4) * 4) = l[e];
    }
  }
}

// The split tile's copy of stage `s`'s row slices.
template <typename P>
__device__ __forceinline__ void copy_slices(const Smem<P>& sm, int s,
                                            int ctid) {
  constexpr int SL16 = P::SLICES * P::SLICE / 16;
  if (ctid < SL16)
    reinterpret_cast<int4*>(sm.slices + P::LS * P::SLICES * P::SLICE)[ctid] =
        reinterpret_cast<const int4*>(sm.slices +
                                      s * P::SLICES * P::SLICE)[ctid];
}

// All consumers split the landed tile of stage `s` into the split tile
// and copy its row slices, a thread's tasks in pairs, each task's load
// after the last task's stores.
template <typename P>
__device__ __forceinline__ void split_tile(const Smem<P>& sm, int s,
                                           int ctid) {
  constexpr int TASKS = 2 * P::DP * 8 * P::TR;
  const uint8_t* land = sm.land + s * P::LAND;
#pragma unroll 2
  for (int task = ctid; task < TASKS; task += P::NC)
    split_task(sm, task,
               *reinterpret_cast<const float4*>(land + task_slot<P>(task)));
  copy_slices(sm, s, ctid);
}

// The same, a thread's loads issued in batches before the batch's stores:
// the compiler may not move a load above a store that might alias it, so
// the pairs above wait out each load's latency. A batch is 8 / NCH loads
// (four registers a load, against O's 32 a chunk of D), one batch after
// the other: at D=128 larger or interleaved batches spill.
template <typename P>
__device__ __forceinline__ void split_tile_batched(const Smem<P>& sm, int s,
                                                   int ctid) {
  constexpr int NK = 2 * P::DP * 8 * P::TR / P::NC;   // tasks a thread
  constexpr int BATCH = NK < 8 / P::NCH ? NK : 8 / P::NCH;
  static_assert(NK * P::NC == 2 * P::DP * 8 * P::TR && NK % BATCH == 0,
                "whole batches of tasks");
  const uint8_t* land = sm.land + s * P::LAND;
#pragma unroll 1
  for (int k0 = 0; k0 < NK; k0 += BATCH) {
    float4 x[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      x[k] = *reinterpret_cast<const float4*>(
          land + task_slot<P>(ctid + (k0 + k) * P::NC));
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      split_task(sm, ctid + (k0 + k) * P::NC, x[k]);
  }
  copy_slices(sm, s, ctid);
}

// acc[64 x TR] = A B^T over D in 3xTF32: A the warpgroup's 64 rows of
// item operand `o`, B the split tile's natural operand `o`; the products'
// two small terms first. Issued, not waited for.
template <typename P>
__device__ __forceinline__ void score_products(const Smem<P>& sm, int o,
                                               int wg,
                                               float (&acc)[P::TR / 2]) {
  constexpr int TR = P::TR, KS = P::D / 8;
  const uint8_t* ahi = sm.res + 2 * o * P::DP * P::RES_P + wg * 64 * ROW_BYTES;
  const uint8_t* alo = ahi + P::DP * P::RES_P;
  const uint8_t* bhi = sm.nat + 2 * o * P::DP * P::TILE_P;
  const uint8_t* blo = bhi + P::DP * P::TILE_P;
#pragma unroll
  for (int k = 0; k < KS; ++k)
    wgmma_ss_tf32<TR>(acc, kmajor_desc_tf32(alo, P::RES_P, k),
                      kmajor_desc_tf32(bhi, P::TILE_P, k), k > 0);
#pragma unroll
  for (int k = 0; k < KS; ++k)
    wgmma_ss_tf32<TR>(acc, kmajor_desc_tf32(ahi, P::RES_P, k),
                      kmajor_desc_tf32(blo, P::TILE_P, k), 1);
#pragma unroll
  for (int k = 0; k < KS; ++k)
    wgmma_ss_tf32<TR>(acc, kmajor_desc_tf32(ahi, P::RES_P, k),
                      kmajor_desc_tf32(bhi, P::TILE_P, k), 1);
}

// part[c] = A X over the tile's rows in 3xTF32, for each 64-column chunk
// c of D: A (64 x TR) the register fragments ahi/alo, X the split tile's
// transposed operand `o`. Issued, not waited for; each tile's product
// starts from zero, for the threads to add.
template <typename P>
__device__ __forceinline__ void contract_products(
    const Smem<P>& sm, int o, float (&part)[P::NCH][32],
    uint32_t (&ahi)[P::TR / 8][4], uint32_t (&alo)[P::TR / 8][4]) {
  constexpr int KC = P::TR / 8;
#pragma unroll
  for (int c = 0; c < P::NCH; ++c) {
    const uint8_t* x = sm.tpose + (o - P::T0) * P::TPN * P::TPOSE_P +
                       c * 64 * ROW_BYTES;
#pragma unroll
    for (int k = 0; k < KC; ++k)
      wgmma_rs_tf32<64>(part[c], alo[k], kmajor_desc_tf32(x, P::TPOSE_P, k),
                        k > 0);
#pragma unroll
    for (int k = 0; k < KC; ++k)
      wgmma_rs_tf32<64>(part[c], ahi[k],
                        kmajor_desc_tf32(x, P::TPOSE_P, KC + k), 1);
#pragma unroll
    for (int k = 0; k < KC; ++k)
      wgmma_rs_tf32<64>(part[c], ahi[k], kmajor_desc_tf32(x, P::TPOSE_P, k),
                        1);
  }
}

// acc += part, once the products into part are waited for.
template <int NCH>
__device__ __forceinline__ void add_parts(float (&acc)[NCH][32],
                                          float (&part)[NCH][32]) {
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    fence_f32(part[c]);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] += part[c][i];
  }
}

// A score tile's element (4j + e: row r + 8 (e / 2), column 8j + c + e % 2)
// into A fragment j: a[0] row r column t <- column 2t, a[1] row r + 8,
// a[2] and a[3] the odd columns (the transposed tile's k order).
__device__ __forceinline__ void to_frag(float x0, float x1, float x2,
                                        float x3, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split_tf32(x0, hi[0], lo[0]);
  split_tf32(x2, hi[1], lo[1]);
  split_tf32(x1, hi[2], lo[2]);
  split_tf32(x3, hi[3], lo[3]);
}

// Store a warpgroup's 64 x 64 accumulator chunk c to rows [row, row + 64)
// of a [rows, D] fp32 output.
// (the thread's rows r and r + 8, columns 8j + col and 8j + col + 1).
template <int D>
__device__ __forceinline__ void store_chunk(float* out, size_t row,
                                            int chunk, int r, int col,
                                            const float (&acc)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float* p = out + (row + r) * D + 64 * chunk + 8 * j + col;
    *reinterpret_cast<float2*>(p) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(p + 8 * D) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ---- wide bodies (D=256) ------------------------------------------------
//
// At D=256 an item's 64 rows are 64 KB of fp32 an operand, 128 KB in hi
// and lo, so a wide plan keeps the item in fp32 alone (two operands: 128
// KB) and splits it as it is used: each k8 slice of the warpgroup's A
// operand into tf32 hi/lo register fragments right before its wgmma
// (item_scores). A landed tile is split in place (hi over the fp32, lo at
// the same place of the split tile's buffer, `nat`), beside its
// transposed copy (`tpose`: a row a column of D, in one or two panel
// rows, hi and lo columns of up to two operands). The two consumer warpgroups each take
// one score product, or half of one's k8 steps, and hand it to the other
// through shared memory (exchange_scores), then each keeps NCH 64-column
// chunks of D of the outputs. A wide plan gives, beside Plan's sizes:
// ITEM_OP (the bytes of an item operand), SK (k8 steps of a warpgroup's
// score product: D / 8, or half of them), G (k8 steps a batch of
// item_scores), NACC (score accumulators), NT (operands transposed: the
// first NT of a tile), NAT0 (the first operand kept natural: hi in place,
// lo at nat + (o - NAT0) DP TILE_P), XCH (bytes between the warpgroups'
// exchange slots in nat).

// Split task `task`'s chunk x of a landed tile in place: for operands
// from NAT0 on, hi over the landed fp32 and lo at the same place of
// `nat` (less NAT0 operands); for the first NT operands the transposed
// hi and lo (row n = column n of the tile; operand o
// in K columns [2 TR o, 2 TR o + TR) hi and the next TR lo, each group of
// 8 tile rows in the order 0 2 4 6 1 3 5 7; K column kc in panel row
// kc / 32, the panel rows D ROW_BYTES apart).
template <typename P>
__device__ __forceinline__ void split_task_inplace(const Smem<P>& sm,
                                                   uint8_t* land, int task,
                                                   const float4& x) {
  constexpr int DP = P::DP, TR = P::TR;
  const int row = task % TR, ch = (task / TR) % 8;
  const int p = (task / (8 * TR)) % DP, o = task / (8 * TR * DP);
  const int slot = task_slot<P>(task);
  uint32_t h[4], l[4];
  split_tf32_bits(x.x, h[0], l[0]);
  split_tf32_bits(x.y, h[1], l[1]);
  split_tf32_bits(x.z, h[2], l[2]);
  split_tf32_bits(x.w, h[3], l[3]);
  if (P::NAT0 == 0 || o >= P::NAT0) {
    *reinterpret_cast<uint4*>(land + slot) =
        make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(sm.nat + slot - P::NAT0 * DP * P::TILE_P) =
        make_uint4(l[0], l[1], l[2], l[3]);
  }
  if (o < P::NT) {
    const int kl = 8 * (row / 8) + 4 * (row % 2) + (row % 8) / 2;
    const int chi = 2 * TR * o + kl, clo = chi + TR;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = p * PANEL_F32 + 4 * ch + e;
      uint8_t* tp = sm.tpose + n * ROW_BYTES;
      if constexpr (2 * TR * P::NT <= PANEL_F32) {   // one panel row
        *reinterpret_cast<uint32_t*>(tp + (((chi / 4) ^ (n % 8)) * 16) +
                                     (chi % 4) * 4) = h[e];
        *reinterpret_cast<uint32_t*>(tp + (((clo / 4) ^ (n % 8)) * 16) +
                                     (clo % 4) * 4) = l[e];
      } else {
        constexpr int ROWS_P = P::D * ROW_BYTES;
        *reinterpret_cast<uint32_t*>(
            tp + (chi / PANEL_F32) * ROWS_P +
            ((((chi % PANEL_F32) / 4) ^ (n % 8)) * 16) + (chi % 4) * 4) =
            h[e];
        *reinterpret_cast<uint32_t*>(
            tp + (clo / PANEL_F32) * ROWS_P +
            ((((clo % PANEL_F32) / 4) ^ (n % 8)) * 16) + (clo % 4) * 4) =
            l[e];
      }
    }
  }
}

// All consumers split the landed tile of stage `s` in place and copy its
// row slices; a thread issues its loads in batches of up to 8, each
// before the batch's stores (a task stores only where it loaded, or
// outside the landed tile).
template <typename P>
__device__ __forceinline__ void split_tile_inplace(const Smem<P>& sm, int s,
                                                   int ctid) {
  constexpr int NK = 2 * P::DP * 8 * P::TR / P::NC;   // tasks a thread
  constexpr int BATCH = NK < 8 ? NK : 8;
  static_assert(NK * P::NC == 2 * P::DP * 8 * P::TR && NK % BATCH == 0,
                "whole batches of tasks");
  uint8_t* land = sm.land + s * P::LAND;
#pragma unroll
  for (int k0 = 0; k0 < NK; k0 += BATCH) {
    float4 x[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      x[k] = *reinterpret_cast<const float4*>(
          land + task_slot<P>(ctid + (k0 + k) * P::NC));
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      split_task_inplace(sm, land, ctid + (k0 + k) * P::NC, x[k]);
  }
  copy_slices(sm, s, ctid);
}

// kmajor_desc_tf32(tile, PANEL_BYTES, k) from the tile's step-0
// descriptor: the address field counts 16-byte units of a shared-memory
// address (below 256 KB), so a step's offset adds to it without a carry.
template <int PANEL_BYTES>
__device__ __forceinline__ uint64_t desc_at(uint64_t d0, int k) {
  return d0 + (uint64_t)(((k / 4) * PANEL_BYTES + 32 * (k % 4)) >> 4);
}

// A warpgroup rewrites the SK / 4 panels from p0 of item operand `o` in
// place for item_scores' loads: in each 16-column group of a row, the
// chunk of lane t holds columns t, t + 4, t + 8 and t + 12 (the A
// fragment's columns t and t + 4 of the group's two k8 steps), and odd
// rows keep their panel's two groups swapped, so that a quarter-warp's
// 16-byte loads (two rows of four lanes) meet eight distinct chunks. Only
// this warpgroup reads those panels.
template <typename P>
__device__ __forceinline__ void permute_item(const Smem<P>& sm, int o,
                                             int p0, int wtid) {
  uint8_t* base = sm.res + o * P::ITEM_OP + p0 * P::RES_P;
#pragma unroll 1
  for (int u = wtid; u < P::IROWS * (P::SK / 4); u += 128) {
    const int row = u % P::IROWS, sw = row % 8, odd = row & 1;
    uint8_t* r = base + (u / P::IROWS) * P::RES_P + row * ROW_BYTES;
    float c[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(r + ((j ^ sw) * 16));
      c[j][0] = v.x;
      c[j][1] = v.y;
      c[j][2] = v.z;
      c[j][3] = v.w;
    }
#pragma unroll
    for (int gp = 0; gp < 2; ++gp)
#pragma unroll
      for (int t = 0; t < 4; ++t)
        *reinterpret_cast<float4*>(r + (((4 * (gp ^ odd) + t) ^ sw) * 16)) =
            make_float4(c[4 * gp][t], c[4 * gp + 1][t], c[4 * gp + 2][t],
                        c[4 * gp + 3][t]);
  }
}

// sc[64 x TR] = A B^T over the SK k8 steps of D from k0 (a multiple of
// 4) in 3xTF32: A the item's 64 rows of operand `oi` (fp32, as
// permute_item left it), each k8 slice split into tf32 hi/lo register
// fragments right before its products (two k8 steps of a row in one
// 16-byte load); B the tile of stage `s`, operand `ot`, split in place.
// The step k0 + k sums into accumulator k % NACC, each from zero, and the
// threads add the NACC of them in a fixed order: each sums SK / NACC
// steps (the tensor core's fp32 sums truncate). Batches of G k8 steps,
// each batch's fragments in the register set that the batch before last
// used, once its products are waited for; waits for all of them before
// it returns.
template <typename P>
__device__ __forceinline__ void item_scores(const Smem<P>& sm, int oi,
                                            int ot, int k0, int s, int wtid,
                                            float (&sc)[P::TR / 2]) {
  constexpr int TR = P::TR, KS = P::SK, G = P::G, NACC = P::NACC;
  static_assert(KS % G == 0 && G % 2 == 0 && KS % NACC == 0 &&
                    NACC % 2 == 0,
                "whole batches of step pairs, and accumulator pairs");
  const int g = 16 * (wtid / 32) + (wtid % 32) / 4;
  // The thread's chunk of the first group of a panel (the second's is
  // this ^ 4), for rows g and g + 8 alike.
  const int q0 = (4 * (g & 1) + wtid % 4) ^ (g % 8);
  const uint8_t* row = sm.res + oi * P::ITEM_OP + (k0 / 4) * P::RES_P +
                       g * ROW_BYTES;
  const uint64_t dhi = kmajor_desc_tf32(
      sm.land + s * P::LAND + ot * P::DP * P::TILE_P, P::TILE_P, k0);
  const uint64_t dlo = kmajor_desc_tf32(
      sm.nat + (ot - P::NAT0) * P::DP * P::TILE_P, P::TILE_P, k0);
  float acc[NACC][TR / 2];
  uint32_t fh[2][G][4], fl[2][G][4];
#pragma unroll
  for (int a = 0; a < NACC; ++a) undef_f32(acc[a]);
#pragma unroll
  for (int b = 0; b < KS / G; ++b) {
    const int set = b % 2;
    float4 xa[G / 2], xb[G / 2];     // rows g and g + 8
#pragma unroll
    for (int j = 0; j < G / 2; ++j) {
      const int k = b * G + 2 * j;   // steps k, k + 1: panel k / 4
      const uint8_t* pa = row + (k / 4) * P::RES_P +
                          ((q0 ^ (4 * ((k % 4) / 2))) * 16);
      xa[j] = *reinterpret_cast<const float4*>(pa);
      xb[j] = *reinterpret_cast<const float4*>(pa + 8 * ROW_BYTES);
    }
#pragma unroll
    for (int j = 0; j < G / 2; ++j) {
      uint32_t(&h0)[4] = fh[set][2 * j];
      uint32_t(&l0)[4] = fl[set][2 * j];
      uint32_t(&h1)[4] = fh[set][2 * j + 1];
      uint32_t(&l1)[4] = fl[set][2 * j + 1];
      split_tf32_bits(xa[j].x, h0[0], l0[0]);
      split_tf32_bits(xb[j].x, h0[1], l0[1]);
      split_tf32_bits(xa[j].y, h0[2], l0[2]);
      split_tf32_bits(xb[j].y, h0[3], l0[3]);
      split_tf32_bits(xa[j].z, h1[0], l1[0]);
      split_tf32_bits(xb[j].z, h1[1], l1[1]);
      split_tf32_bits(xa[j].w, h1[2], l1[2]);
      split_tf32_bits(xb[j].w, h1[3], l1[3]);
    }
    fence_frags(fh[set]);
    fence_frags(fl[set]);
    wgmma_fence();
    // The two small terms of each step first, each round over the batch.
#pragma unroll
    for (int kk = 0; kk < G; ++kk) {
      const int k = b * G + kk;
      wgmma_rs_tf32<TR>(acc[k % NACC], fl[set][kk],
                        desc_at<P::TILE_P>(dhi, k), k >= NACC);
    }
#pragma unroll
    for (int kk = 0; kk < G; ++kk) {
      const int k = b * G + kk;
      wgmma_rs_tf32<TR>(acc[k % NACC], fh[set][kk],
                        desc_at<P::TILE_P>(dlo, k), 1);
    }
#pragma unroll
    for (int kk = 0; kk < G; ++kk) {
      const int k = b * G + kk;
      wgmma_rs_tf32<TR>(acc[k % NACC], fh[set][kk],
                        desc_at<P::TILE_P>(dhi, k), 1);
    }
    wgmma_commit();
    if (b > 0) wgmma_wait<1>();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int a = 0; a < NACC; ++a) fence_f32(acc[a]);
  // A fixed tree: pairs (0, 1), (2, 3), ..., then their sums in order.
#pragma unroll
  for (int i = 0; i < TR / 2; ++i) {
    float sum = acc[0][i] + acc[1][i];
#pragma unroll
    for (int a = 2; a < NACC; a += 2) sum += acc[a][i] + acc[a + 1][i];
    sc[i] = sum;
  }
}

// The two warpgroups swap their score tiles: warpgroup wg's goes where
// only its own products read (nat + wg XCH: the lo half of the tile's
// operand wg, or of its panels of one operand, once its products are
// waited for), and the other's comes back into `other` in the same
// accumulator layout (thread wtid of both holds the same elements).
template <typename P>
__device__ __forceinline__ void exchange_scores(const Smem<P>& sm, int wg,
                                                int wtid,
                                                const float (&mine)[P::TR / 2],
                                                float (&other)[P::TR / 2]) {
  constexpr int N = P::TR / 2;
  static_assert(128 * N * 4 <= P::XCH, "a warpgroup's tile fits its slot");
  float* out = reinterpret_cast<float*>(sm.nat + wg * P::XCH) + wtid * N;
  const float* in =
      reinterpret_cast<const float*>(sm.nat + (1 - wg) * P::XCH) + wtid * N;
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(out + i) =
        make_float4(mine[i], mine[i + 1], mine[i + 2], mine[i + 3]);
  named_barrier(1, P::NC);
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(in + i);
    other[i] = v.x;
    other[i + 1] = v.y;
    other[i + 2] = v.z;
    other[i + 3] = v.w;
  }
}

// part[c] = A X over the tile's rows in 3xTF32 for chunks c0 + c of D, c
// < NC (the plan's NCH, or fewer): A (64 x TR) the register fragments
// ahi/alo, X the transposed
// operand `u` (hi in K steps [2 KC u, 2 KC u + KC), lo in the next KC;
// its panel rows D ROW_BYTES apart). Issued, not waited for; each chunk's
// product starts from zero.
template <typename P, int NC>
__device__ __forceinline__ void contract_wide(
    const Smem<P>& sm, int u, int c0, float (&part)[NC][32],
    uint32_t (&ahi)[P::TR / 8][4], uint32_t (&alo)[P::TR / 8][4]) {
  constexpr int KC = P::TR / 8, ROWS_P = P::D * ROW_BYTES;
  const int khi = 2 * KC * u, klo = khi + KC;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const uint8_t* x = sm.tpose + (c0 + c) * 64 * ROW_BYTES;
#pragma unroll
    for (int k = 0; k < KC; ++k)
      wgmma_rs_tf32<64>(part[c], alo[k],
                        kmajor_desc_tf32(x, ROWS_P, khi + k), k > 0);
#pragma unroll
    for (int k = 0; k < KC; ++k)
      wgmma_rs_tf32<64>(part[c], ahi[k],
                        kmajor_desc_tf32(x, ROWS_P, klo + k), 1);
#pragma unroll
    for (int k = 0; k < KC; ++k)
      wgmma_rs_tf32<64>(part[c], ahi[k],
                        kmajor_desc_tf32(x, ROWS_P, khi + k), 1);
  }
}

// A body's persistent grid over BH * L / IROWS items (at most one block
// per SM), with the kernel opted into the plan's shared memory.
template <typename P, typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int BH, int L, int* grid) {
  int dev = 0, sms = 0;
  *grid = BH * (L / P::IROWS);
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::SMEM);
  if (sms < *grid) *grid = sms;
  return err;
}

}  // namespace lddl_tf32x3
