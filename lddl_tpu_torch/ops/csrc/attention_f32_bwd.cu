// fp32 attention backward for Hopper (sm_90a) on the tensor cores: the dQ
// body and the dK/dV body of the fp32 builds, every product a 3xTF32
// wgmma. Each body is instantiated under the fp32 set's regime names, with
// a C entry point per kernel call of the bf16 set:
//
//   online_bwd_dq_f32_kernel   replaces _bwd_dq_kernel   (lddl_online_bwd_dq_f32)
//   online_bwd_dkv_f32_kernel  replaces _bwd_dkv_kernel  (lddl_online_bwd_dkv_f32)
//   onekv_bwd_dkv_f32_kernel } together replace _onekv_bwd_kernel
//   onekv_bwd_dq_f32_kernel  } (lddl_onekv_bwd_f32 launches both)
//
// (all in lddl_tpu/ops/flash_attention.py). Built at D=64 and 128; at
// D=256 the online pair stays on the SIMT bodies of attention_f32.cu (see
// Plan), which also holds the fp32 forwards.
//
// What they compute: attention_f32.cu's backward, on fp32 operands:
//   S  = Q K^T * scale + bias, bias = 0 where kmask > 0 && kmask == qmask,
//        else -1e9 (fp32, added to the scaled score; never -inf);
//   P  = exp(S - LSE), dP = dO V^T, dS = P (dP - delta) scale;
//   dq:  walk the K/V tiles, dQ += dS K;
//   dkv: walk the Q/dO tiles, dV += P^T dO, dK += dS^T Q.
// expf, not the fast-math intrinsic. No tile is skipped: padded query rows
// (qmask 0) see every key disallowed and spread over all L_pad keys, as in
// the reference. No atomics: every output element is written by one thread
// of one block, and each block sums in a fixed order, so two launches give
// bit-identical results. Layout: q/k/v/dO/dQ/dK/dV [B*H, L_pad, D] fp32,
// masks int32 [B, L_pad], LSE and delta (rowsum(dO * O), computed outside)
// fp32 [B*H, L_pad]; L_pad a multiple of 128.
//
// 3xTF32: a TF32 product rounds each operand to a 10-bit mantissa, so
// every operand x is split as hi = tf32(x), lo = tf32(x - hi) (cvt.rna;
// |x - hi - lo| <= 2^-22 |x|) and a product a b is taken as
// lo_a hi_b + hi_a lo_b + hi_a hi_b, three wgmma into one fp32 accumulator,
// the two small terms first; lo_a lo_b (<= 2^-22 relative) is dropped.
//
// What bounds them on this card: at the BART path's shape (B=8, H=12,
// L_pad 1024, D=64) dQ recomputes S and dP and does dS K, 38.7 GFLOP of
// fp32 products, dK/dV 51.5; three TF32 products each are 116 and 155
// GFLOP, 0.23 and 0.31 ms at 494.7 TFLOP/s, against 0.58 and 0.77 ms of
// FFMA at 66.9. Operands are 31-38 MB (~0.01 ms at 3.35 TB/s): the tensor
// cores bound them. At the TF32 peak a k8 wgmma with both operands in
// shared memory reads 128 bytes a clock at N=64 (the SM's whole
// shared-memory rate) and 192 at N=32, so the score products are bound by
// shared memory before the tensor cores.
//
// Design (the bf16 backward's, online_attention_bwd.cu, on tf32): a block
// of NWG consumer warpgroups and a producer warpgroup works on items of
// 64 NWG rows of one (batch*head): keys (dK/dV) or queries (dQ). The
// producer's one thread loads an item's own rows by TMA into the item
// buffer, and streams the other side (Q and dO, or K and V) in TR-row
// tiles with their mask, LSE and delta slices through a ring of landing
// stages guarded by full/empty mbarriers. tf32 wgmma reads both operands
// K-major, so the products that contract over the streamed rows (dV +=
// P^T dO, dK += dS^T Q, dQ += dS K) need the streamed tile transposed:
// - each consumer warpgroup splits its own rows of the item in place (hi
//   over the fp32, lo beside it) once an item;
// - all consumers split each landed tile into one split buffer: hi and lo
//   in the landed (natural) layout for the score products, and hi and lo
//   transposed (rows = D) for the contracting product, then free the
//   landing stage, so the producer's next loads overlap the products;
// - each warpgroup computes its 64 x TR score tiles with wgmma m64nTRk8
//   (both operands from shared memory) into registers, applies bias, exp
//   and dS there, splits P and dS in registers and feeds them to the
//   contracting product as the register A operand (m64n64k8 over 64-column
//   chunks of D): no score tile passes through shared memory.
// The A fragment of a k8 step holds columns t and t + 4 of a row where the
// score accumulator holds columns 2t and 2t + 1; the split pass writes
// the transposed tile's K columns in the order 0 2 4 6 1 3 5 7 within each
// group of 8, so that the accumulator's pairs are the fragment as they
// stand (the k order of a product's sum is free).
// The split runs between the products, by every consumer thread. Two
// other placements measured no faster on this card: in the producer
// warpgroup beside the products (its four warps split more slowly than
// the consumers' eight, and gate both consumer warpgroups), and each half
// of the split tile beside the other half's products (the split and the
// score products share the shared-memory rate). setmaxnreg moves
// registers from the producer warpgroup (24) to the consumers (240) at
// D=64. The epilogue stores the fp32 accumulators straight to device
// memory.
// Every kernel runs a persistent grid of at most one block per SM; a block
// walks the items blockIdx.x, blockIdx.x + gridDim.x, ...; the landing
// ring runs on across items.

#include <math.h>

#include "hopper_tiles.cuh"

namespace {

using namespace lddl_hopper;

constexpr int CONSUMER_REGS = 240;
constexpr int PRODUCER_REGS = 24;
constexpr float NEG_BIG = -1e9f;

// How a body (DKV: the dK/dV body, else the dQ body) divides its work and
// its shared memory at head dim D. A tile's hi/lo pair takes twice the
// bf16 tile's bytes, and each streamed tile is kept in two layouts, so
// shared memory sets the sizes:
// - D=64: two consumer warpgroups, items of 128 rows (their hi and lo
//   take 128 KB), streamed tiles of 32 rows (split: 64 KB for dK/dV, 48
//   KB for dQ), two landing stages of 16 KB: 226 KB for dK/dV.
// - D=128: one consumer warpgroup, items of 64 rows (128 KB), tiles of 16
//   rows (the same bytes as at D=64).
// - D=256 is not built here: an item's 64 rows alone would take 256 KB in
//   hi and lo.
template <int D, bool DKV>
struct Plan {
  static_assert(D == 64 || D == 128, "built at D=64 and 128");
  static constexpr int NWG = D == 64 ? 2 : 1;      // consumer warpgroups
  static constexpr int NC = 128 * NWG;             // consumer threads
  static constexpr int NTHREADS = NC + 128;        // + the producer's
  static constexpr int IROWS = 64 * NWG;           // rows of a work item
  static constexpr int TR = D == 64 ? 32 : 16;     // rows of a streamed tile
  static constexpr int DP = D / PANEL_F32;         // panels of a D-wide row
  static constexpr int NCH = D / 64;               // 64-column output chunks
  static constexpr int NT = DKV ? 2 : 1;           // tiles transposed
  static constexpr int SLICES = DKV ? 3 : 1;       // row slices a tile
  static constexpr int SLICE = TR * 4;             // bytes of a slice
  static constexpr int RES_P = IROWS * ROW_BYTES;  // an item buffer panel
  static constexpr int TILE_P = TR * ROW_BYTES;    // a streamed panel
  static constexpr int TPOSE_P = D * ROW_BYTES;    // a transposed panel
  static constexpr int TPN = 2 * TR / PANEL_F32;   // its panels: hi, lo cols
  static constexpr int LS = 2;                     // landing stages
  // The item buffer (two operands, hi and lo), the split tile (two
  // operands hi and lo; NT of them transposed), the landing stages (two
  // raw tiles), the row slices (the stages' and the split tile's copy),
  // the barriers, and room to align the base to 1024 bytes.
  static constexpr int RES = 4 * DP * RES_P;
  static constexpr int NAT = 4 * DP * TILE_P;
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
template <int D, bool DKV>
struct Smem {
  using P = Plan<D, DKV>;
  uint8_t* res;     // operand o, half h (0 hi, 1 lo): + (2o + h) DP RES_P
  uint8_t* nat;     // the split tile, natural: + (2o + h) DP TILE_P
  uint8_t* tpose;   // transposed operand o: + o TPN TPOSE_P
  uint8_t* land;    // stage s: + s LAND, operand o: + o DP TILE_P
  uint8_t* slices;  // stage s: + s SLICES SLICE; the split tile's at LS
  uint64_t* full;
  uint64_t* empty;
  uint64_t* res_full;
  uint64_t* res_empty;

  __device__ __forceinline__ explicit Smem(uint8_t* raw) {
    res = align_1024(raw);
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

// The producer thread: per item, the item's own rows of operands `ra`
// and `rb` once (into the hi halves of the item buffer, once the last
// item's consumers are done with it), then the tiles of `sa` and `sb` and
// their row slices through the landing ring. `slice_src` gives a tile's
// slices (b, the tile's first row (bh * L + i * TR), the stage's slices).
template <int D, bool DKV, typename SliceFn>
__device__ __forceinline__ void produce(const Smem<D, DKV>& sm,
                                        const CUtensorMap* ra,
                                        const CUtensorMap* rb,
                                        const CUtensorMap* sa,
                                        const CUtensorMap* sb, int BH,
                                        int L, int H, SliceFn slice_src) {
  using P = Plan<D, DKV>;
  constexpr int DP = P::DP, TR = P::TR;
  const int nblk = L / P::IROWS, nitems = BH * nblk, ntiles = L / TR;
  int t = 0;
  for (int item = blockIdx.x, j = 0; item < nitems;
       item += gridDim.x, ++j) {
    const int bh = item / nblk, r0 = (item % nblk) * P::IROWS, b = bh / H;
    const int row0 = bh * L;
    mbar_wait(sm.res_empty, (j & 1) ^ 1);
    mbar_arrive_expect_tx(sm.res_full, 2 * DP * P::RES_P);
    for (int p = 0; p < DP; ++p)
      for (int h = 0; h < P::IROWS / TR; ++h) {
        tma_load_2d(sm.res + p * P::RES_P + h * P::TILE_P, ra,
                    p * PANEL_F32, row0 + r0 + h * TR, sm.res_full);
        tma_load_2d(sm.res + (2 * DP + p) * P::RES_P + h * P::TILE_P, rb,
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
template <int D, bool DKV>
__device__ __forceinline__ void split_item(const Smem<D, DKV>& sm, int wg,
                                           int wtid) {
  using P = Plan<D, DKV>;
  constexpr int SLOTS = 64 * ROW_BYTES / 16;   // a panel's rows of the wg
#pragma unroll 1
  for (int o = 0; o < 2; ++o)
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

// All consumers split the landed tile of stage `s` into the split tile:
// both operands' hi and lo in the landed layout, the first NT of them also
// transposed (row n = column n of the tile; hi in K columns [0, TR), lo in
// [TR, 2 TR), each group of 8 tile rows in the order 0 2 4 6 1 3 5 7), and
// the stage's row slices copied. A task is one 16-byte chunk; the 32
// lanes of a warp take 32 rows (or 16 rows of two chunks) of one column
// chunk, so the transposed stores hit 32 banks.
template <int D, bool DKV>
__device__ __forceinline__ void split_tile(const Smem<D, DKV>& sm, int s,
                                           int ctid) {
  using P = Plan<D, DKV>;
  constexpr int DP = P::DP, TR = P::TR, TASKS = 2 * DP * 8 * TR;
  const uint8_t* land = sm.land + s * P::LAND;
#pragma unroll 2
  for (int task = ctid; task < TASKS; task += P::NC) {
    const int row = task % TR, ch = (task / TR) % 8;
    const int p = (task / (8 * TR)) % DP, o = task / (8 * TR * DP);
    const int slot = (o * DP + p) * P::TILE_P + row * ROW_BYTES +
                     ((ch ^ (row % 8)) * 16);
    const float4 x = *reinterpret_cast<const float4*>(land + slot);
    uint32_t h[4], l[4];
    split_tf32(x.x, h[0], l[0]);
    split_tf32(x.y, h[1], l[1]);
    split_tf32(x.z, h[2], l[2]);
    split_tf32(x.w, h[3], l[3]);
    uint8_t* nat = sm.nat + o * DP * P::TILE_P + slot;   // operand o's hi
    *reinterpret_cast<uint4*>(nat) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(nat + DP * P::TILE_P) =
        make_uint4(l[0], l[1], l[2], l[3]);
    if (o < P::NT) {
      const int kl = 8 * (row / 8) + 4 * (row % 2) + (row % 8) / 2;
      uint8_t* tp = sm.tpose + o * P::TPN * P::TPOSE_P;
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
  constexpr int SL16 = P::SLICES * P::SLICE / 16;
  if (ctid < SL16)
    reinterpret_cast<int4*>(sm.slices + P::LS * P::SLICES * P::SLICE)[ctid] =
        reinterpret_cast<const int4*>(sm.slices +
                                      s * P::SLICES * P::SLICE)[ctid];
}

// acc[64 x TR] = A B^T over D in 3xTF32: A the warpgroup's 64 rows of
// item operand `o`, B the split tile's natural operand `o`; the products'
// two small terms first. Issued, not waited for.
template <int D, bool DKV>
__device__ __forceinline__ void score_products(
    const Smem<D, DKV>& sm, int o, int wg,
    float (&acc)[Plan<D, DKV>::TR / 2]) {
  using P = Plan<D, DKV>;
  constexpr int TR = P::TR, KS = D / 8;
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
// transposed operand `o`. Issued, not waited for. A tile's product starts
// from zero and is added to the running sum by the threads (add_parts):
// the tensor core's fp32 sums truncate, and over the hundreds of k steps
// of a long row their error grows past 1e-5 of the result.
template <int D, bool DKV>
__device__ __forceinline__ void contract_products(
    const Smem<D, DKV>& sm, int o, float (&part)[Plan<D, DKV>::NCH][32],
    uint32_t (&ahi)[Plan<D, DKV>::TR / 8][4],
    uint32_t (&alo)[Plan<D, DKV>::TR / 8][4]) {
  using P = Plan<D, DKV>;
  constexpr int KC = P::TR / 8;
#pragma unroll
  for (int c = 0; c < P::NCH; ++c) {
    const uint8_t* x = sm.tpose + o * P::TPN * P::TPOSE_P +
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

// The dK/dV mainloop: per work item (IROWS keys of one batch*head), walk
// the Q/dO tiles. The maps are the kernel's __grid_constant__ parameters.
template <int D>
__device__ __forceinline__ void dkv_body(
    uint8_t* smem_raw, const CUtensorMap* map_q, const CUtensorMap* map_k,
    const CUtensorMap* map_v, const CUtensorMap* map_do,
    const int* __restrict__ kmask, const int* __restrict__ qmask,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int BH, int L, int H,
    float scale) {
  using P = Plan<D, true>;
  constexpr int TR = P::TR, KC = TR / 8, NCH = P::NCH;
  const Smem<D, true> sm(smem_raw);
  const int nblk = L / P::IROWS, nitems = BH * nblk, ntiles = L / TR;

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

  if (threadIdx.x >= P::NC) {
    // Producer: K and V rows an item, then the Q/dO ring.
    if constexpr (P::NWG == 2) setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != P::NC) return;
    produce<D, true>(sm, map_k, map_v, map_q, map_do, BH, L, H,
                     [&](int b, int row, int col, uint8_t* sl,
                         uint64_t* bar) {
                       bulk_load(sl, qmask + (size_t)b * L + col, P::SLICE,
                                 bar);
                       bulk_load(sl + P::SLICE, lse + row, P::SLICE, bar);
                       bulk_load(sl + 2 * P::SLICE, delta + row, P::SLICE,
                                 bar);
                     });
    return;
  }

  // Consumers: warpgroup wg owns key rows [64 wg, 64 wg + 64) of an item;
  // its thread holds rows r and r + 8 (keys) and, for each 8-column chunk
  // j, columns 8j + c and 8j + c + 1 (queries) of the score tiles.
  if constexpr (P::NWG == 2) setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128;
  const int r = 16 * (wtid / 32) + (wtid % 32) / 4, c = 2 * (wtid % 4);
  const int* qm = reinterpret_cast<const int*>(
      sm.slices + P::LS * P::SLICES * P::SLICE);
  const float* ql = reinterpret_cast<const float*>(qm + TR);
  const float* qd = ql + TR;
  float dkacc[NCH][32], dvacc[NCH][32], part[NCH][32];
  float st[TR / 2], dpt[TR / 2];
  uint32_t phi[KC][4], plo[KC][4], shi[KC][4], slo[KC][4];
#pragma unroll
  for (int i = 0; i < TR / 2; ++i) st[i] = dpt[i] = 0.0f;
  int t = 0;
  for (int item = blockIdx.x, j = 0; item < nitems;
       item += gridDim.x, ++j) {
    const int bh = item / nblk, k0 = (item % nblk) * P::IROWS, b = bh / H;
    const size_t krow = (size_t)bh * L + k0 + 64 * wg;
    const int km0 = kmask[(size_t)b * L + k0 + 64 * wg + r];
    const int km1 = kmask[(size_t)b * L + k0 + 64 * wg + r + 8];
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc)
#pragma unroll
      for (int i = 0; i < 32; ++i) dkacc[cc][i] = dvacc[cc][i] = 0.0f;
    mbar_wait(sm.res_full, j & 1);
    split_item<D, true>(sm, wg, wtid);
    fence_proxy_async();
    named_barrier(2 + wg, 128);

    for (int i = 0; i < ntiles; ++i, ++t) {
      const int s = t % P::LS;
      mbar_wait(&sm.full[s], (t / P::LS) & 1);
      named_barrier(1, P::NC);    // every product of the last tile is done
      split_tile<D, true>(sm, s, threadIdx.x);
      mbar_arrive(&sm.empty[s]);
      fence_proxy_async();
      named_barrier(1, P::NC);    // the split tile is written

      // S^T = K Q^T and dP^T = V dO^T (64 keys x TR queries).
      fence_f32(st);
      fence_f32(dpt);
      wgmma_fence();
      score_products<D, true>(sm, 0, wg, st);
      score_products<D, true>(sm, 1, wg, dpt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_f32(st);
      fence_f32(dpt);

      // P^T = exp(S^T scale + bias - LSE), dS^T = P^T (dP^T - delta)
      // scale, each split into tf32 A fragments.
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        const int2 m = *reinterpret_cast<const int2*>(qm + 8 * jj + c);
        const float2 l = *reinterpret_cast<const float2*>(ql + 8 * jj + c);
        const float2 d = *reinterpret_cast<const float2*>(qd + 8 * jj + c);
        const float p0 = expf(st[4 * jj + 0] * scale + bias(km0, m.x) - l.x);
        const float p1 = expf(st[4 * jj + 1] * scale + bias(km0, m.y) - l.y);
        const float p2 = expf(st[4 * jj + 2] * scale + bias(km1, m.x) - l.x);
        const float p3 = expf(st[4 * jj + 3] * scale + bias(km1, m.y) - l.y);
        to_frag(p0, p1, p2, p3, phi[jj], plo[jj]);
        to_frag(p0 * (dpt[4 * jj + 0] - d.x) * scale,
                p1 * (dpt[4 * jj + 1] - d.y) * scale,
                p2 * (dpt[4 * jj + 2] - d.x) * scale,
                p3 * (dpt[4 * jj + 3] - d.y) * scale, shi[jj], slo[jj]);
      }

      // dV += P^T dO, then dK += dS^T Q (the transposed dO and Q), each a
      // tile's partial product added by the threads.
      fence_frags(phi);
      fence_frags(plo);
      fence_frags(shi);
      fence_frags(slo);
#pragma unroll
      for (int cc = 0; cc < NCH; ++cc) fence_f32(part[cc]);
      wgmma_fence();
      contract_products<D, true>(sm, 1, part, phi, plo);
      wgmma_commit();
      wgmma_wait<0>();
      add_parts(dvacc, part);
      wgmma_fence();
      contract_products<D, true>(sm, 0, part, shi, slo);
      wgmma_commit();
      wgmma_wait<0>();
      add_parts(dkacc, part);
      fence_frags(phi);
      fence_frags(plo);
      fence_frags(shi);
      fence_frags(slo);
    }

    // The item's rows are dead: free the item buffer, then store.
    mbar_arrive(sm.res_empty);
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc) {
      store_chunk<D>(dk, krow, cc, r, c, dkacc[cc]);
      store_chunk<D>(dv, krow, cc, r, c, dvacc[cc]);
    }
  }
}

// The dQ mainloop: per work item (IROWS queries of one batch*head), walk
// the K/V tiles.
template <int D>
__device__ __forceinline__ void dq_body(
    uint8_t* smem_raw, const CUtensorMap* map_q, const CUtensorMap* map_k,
    const CUtensorMap* map_v, const CUtensorMap* map_do,
    const int* __restrict__ kmask, const int* __restrict__ qmask,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int BH, int L, int H, float scale) {
  using P = Plan<D, false>;
  constexpr int TR = P::TR, KC = TR / 8, NCH = P::NCH;
  const Smem<D, false> sm(smem_raw);
  const int nblk = L / P::IROWS, nitems = BH * nblk, ntiles = L / TR;

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

  if (threadIdx.x >= P::NC) {
    // Producer: Q and dO rows an item, then the K/V ring.
    if constexpr (P::NWG == 2) setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != P::NC) return;
    produce<D, false>(sm, map_q, map_do, map_k, map_v, BH, L, H,
                      [&](int b, int, int col, uint8_t* sl, uint64_t* bar) {
                        bulk_load(sl, kmask + (size_t)b * L + col, P::SLICE,
                                  bar);
                      });
    return;
  }

  // Consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) of an
  // item; its thread holds rows r and r + 8 (queries) and columns 8j + c,
  // 8j + c + 1 (keys) of each score tile.
  if constexpr (P::NWG == 2) setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128;
  const int r = 16 * (wtid / 32) + (wtid % 32) / 4, c = 2 * (wtid % 4);
  const int* km = reinterpret_cast<const int*>(
      sm.slices + P::LS * P::SLICES * P::SLICE);
  float dqacc[NCH][32], part[NCH][32], sc[TR / 2], dp[TR / 2];
  uint32_t shi[KC][4], slo[KC][4];
#pragma unroll
  for (int i = 0; i < TR / 2; ++i) sc[i] = dp[i] = 0.0f;
  int t = 0;
  for (int item = blockIdx.x, j = 0; item < nitems;
       item += gridDim.x, ++j) {
    const int bh = item / nblk, q0 = (item % nblk) * P::IROWS, b = bh / H;
    const size_t qrow = (size_t)bh * L + q0 + 64 * wg;
    const int qm0 = qmask[(size_t)b * L + q0 + 64 * wg + r];
    const int qm1 = qmask[(size_t)b * L + q0 + 64 * wg + r + 8];
    const float lse0 = lse[qrow + r], lse1 = lse[qrow + r + 8];
    const float dl0 = delta[qrow + r], dl1 = delta[qrow + r + 8];
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc)
#pragma unroll
      for (int i = 0; i < 32; ++i) dqacc[cc][i] = 0.0f;
    mbar_wait(sm.res_full, j & 1);
    split_item<D, false>(sm, wg, wtid);
    fence_proxy_async();
    named_barrier(2 + wg, 128);

    for (int i = 0; i < ntiles; ++i, ++t) {
      const int s = t % P::LS;
      mbar_wait(&sm.full[s], (t / P::LS) & 1);
      named_barrier(1, P::NC);    // every product of the last tile is done
      split_tile<D, false>(sm, s, threadIdx.x);
      mbar_arrive(&sm.empty[s]);
      fence_proxy_async();
      named_barrier(1, P::NC);    // the split tile is written

      // S = Q K^T and dP = dO V^T (64 queries x TR keys).
      fence_f32(sc);
      fence_f32(dp);
      wgmma_fence();
      score_products<D, false>(sm, 0, wg, sc);
      score_products<D, false>(sm, 1, wg, dp);
      wgmma_commit();
      wgmma_wait<0>();
      fence_f32(sc);
      fence_f32(dp);

      // P = exp(S scale + bias - LSE); dS = P (dP - delta) scale, split
      // into tf32 A fragments.
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        const int2 m = *reinterpret_cast<const int2*>(km + 8 * jj + c);
        const float p0 = expf(sc[4 * jj + 0] * scale + bias(m.x, qm0) - lse0);
        const float p1 = expf(sc[4 * jj + 1] * scale + bias(m.y, qm0) - lse0);
        const float p2 = expf(sc[4 * jj + 2] * scale + bias(m.x, qm1) - lse1);
        const float p3 = expf(sc[4 * jj + 3] * scale + bias(m.y, qm1) - lse1);
        to_frag(p0 * (dp[4 * jj + 0] - dl0) * scale,
                p1 * (dp[4 * jj + 1] - dl0) * scale,
                p2 * (dp[4 * jj + 2] - dl1) * scale,
                p3 * (dp[4 * jj + 3] - dl1) * scale, shi[jj], slo[jj]);
      }

      // dQ += dS K (the transposed K), a tile's partial product added by
      // the threads.
      fence_frags(shi);
      fence_frags(slo);
#pragma unroll
      for (int cc = 0; cc < NCH; ++cc) fence_f32(part[cc]);
      wgmma_fence();
      contract_products<D, false>(sm, 0, part, shi, slo);
      wgmma_commit();
      wgmma_wait<0>();
      add_parts(dqacc, part);
      fence_frags(shi);
      fence_frags(slo);
    }

    mbar_arrive(sm.res_empty);
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc)
      store_chunk<D>(dq, qrow, cc, r, c, dqacc[cc]);
  }
}

// The __global__ kernels: the two regimes run the same bodies under their
// own names, so the profiler tells them apart.
#define LDDL_DKV_KERNEL(name)                                               \
  template <int D>                                                          \
  __global__ void __launch_bounds__(Plan<D, true>::NTHREADS, 1) name(       \
      const __grid_constant__ CUtensorMap map_q,                            \
      const __grid_constant__ CUtensorMap map_k,                            \
      const __grid_constant__ CUtensorMap map_v,                            \
      const __grid_constant__ CUtensorMap map_do,                           \
      const int* __restrict__ kmask, const int* __restrict__ qmask,         \
      const float* __restrict__ lse, const float* __restrict__ delta,       \
      float* __restrict__ dk, float* __restrict__ dv, int BH, int L, int H, \
      float scale) {                                                        \
    extern __shared__ uint8_t smem_raw[];                                   \
    dkv_body<D>(smem_raw, &map_q, &map_k, &map_v, &map_do, kmask, qmask,    \
                lse, delta, dk, dv, BH, L, H, scale);                       \
  }
#define LDDL_DQ_KERNEL(name)                                                \
  template <int D>                                                          \
  __global__ void __launch_bounds__(Plan<D, false>::NTHREADS, 1) name(      \
      const __grid_constant__ CUtensorMap map_q,                            \
      const __grid_constant__ CUtensorMap map_k,                            \
      const __grid_constant__ CUtensorMap map_v,                            \
      const __grid_constant__ CUtensorMap map_do,                           \
      const int* __restrict__ kmask, const int* __restrict__ qmask,         \
      const float* __restrict__ lse, const float* __restrict__ delta,       \
      float* __restrict__ dq, int BH, int L, int H, float scale) {          \
    extern __shared__ uint8_t smem_raw[];                                   \
    dq_body<D>(smem_raw, &map_q, &map_k, &map_v, &map_do, kmask, qmask,     \
               lse, delta, dq, BH, L, H, scale);                            \
  }

LDDL_DKV_KERNEL(online_bwd_dkv_f32_kernel)
LDDL_DQ_KERNEL(online_bwd_dq_f32_kernel)
LDDL_DKV_KERNEL(onekv_bwd_dkv_f32_kernel)
LDDL_DQ_KERNEL(onekv_bwd_dq_f32_kernel)

#undef LDDL_DKV_KERNEL
#undef LDDL_DQ_KERNEL

// Tensor maps over q, k, v, dO ([BH * L, D] fp32, boxes of TR rows), the
// persistent grid (at most one block per SM), and the launch's error.
template <int D, bool DKV, typename Kernel, typename... Out>
int launch(Kernel kernel, const void* q, const void* k, const void* v,
           const void* dout, const void* km, const void* qm,
           const void* lse, const void* delta, int BH, int L, int H,
           float scale, cudaStream_t stream, Out... out) {
  using P = Plan<D, DKV>;
  if (!shape_ok(BH, L, 128)) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, dout};
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 4 && err == cudaSuccess; ++i)
    err = make_map_f32(&maps[i], ptrs[i], (uint64_t)BH * L, D, P::TR);
  int grid = BH * (L / P::IROWS), dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::SMEM);
  if (err != cudaSuccess) return (int)err;
  if (sms < grid) grid = sms;
  kernel<<<grid, P::NTHREADS, P::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const int*)km, (const int*)qm,
      (const float*)lse, (const float*)delta, static_cast<float*>(out)...,
      BH, L, H,
      scale);
  return (int)cudaGetLastError();
}

// The single-block backward: dK/dV, then dQ.
template <int D>
int launch_onekv(const void* q, const void* k, const void* v,
                 const void* km, const void* qm, const void* dout,
                 const void* lse, const void* delta, void* dq, void* dk,
                 void* dv, int BH, int L, int H, float scale,
                 cudaStream_t stream) {
  const int err = launch<D, true>(onekv_bwd_dkv_f32_kernel<D>, q, k, v, dout,
                                  km, qm, lse, delta, BH, L, H, scale,
                                  stream, dk, dv);
  if (err != 0) return err;
  return launch<D, false>(onekv_bwd_dq_f32_kernel<D>, q, k, v, dout, km, qm,
                          lse, delta, BH, L, H, scale, stream, dq);
}

}  // namespace

// Plain C interface (loaded with ctypes), the bf16 backward entry points'
// arguments under an _f32 name. Each returns the cudaError_t of its
// launches: 0 on success, cudaErrorInvalidValue at a head dim that is not
// built here. Inputs are checked by the Python wrapper.
extern "C" {

int lddl_onekv_bwd_f32(const void* q, const void* k, const void* v,
                       const void* kmask, const void* qmask,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, void* dk, void* dv, int BH, int L, int H,
                       int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_onekv<64>(q, k, v, kmask, qmask, dout, lse, delta, dq, dk,
                            dv, BH, L, H, scale, s);
  if (D == 128)
    return launch_onekv<128>(q, k, v, kmask, qmask, dout, lse, delta, dq,
                             dk, dv, BH, L, H, scale, s);
  return (int)cudaErrorInvalidValue;
}

int lddl_online_bwd_dq_f32(const void* q, const void* k, const void* v,
                           const void* kmask, const void* qmask,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int BH, int L, int H,
                           int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64, false>(online_bwd_dq_f32_kernel<64>, q, k, v, dout,
                             kmask, qmask, lse, delta, BH, L, H, scale, s,
                             dq);
  if (D == 128)
    return launch<128, false>(online_bwd_dq_f32_kernel<128>, q, k, v, dout,
                              kmask, qmask, lse, delta, BH, L, H, scale, s,
                              dq);
  return (int)cudaErrorInvalidValue;
}

int lddl_online_bwd_dkv_f32(const void* q, const void* k, const void* v,
                            const void* kmask, const void* qmask,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int BH,
                            int L, int H, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64, true>(online_bwd_dkv_f32_kernel<64>, q, k, v, dout,
                            kmask, qmask, lse, delta, BH, L, H, scale, s, dk,
                            dv);
  if (D == 128)
    return launch<128, true>(online_bwd_dkv_f32_kernel<128>, q, k, v, dout,
                             kmask, qmask, lse, delta, BH, L, H, scale, s,
                             dk, dv);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
