// fp32 attention forward for Hopper (sm_90a) on the tensor cores: one
// body, every product a 3xTF32 wgmma, instantiated under the fp32 set's
// regime names with a C entry point each:
//
//   onekv_fwd_f32_kernel   replaces _onekv_fwd_kernel  (lddl_onekv_fwd_f32)
//   online_fwd_f32_kernel  replaces _fwd_kernel        (lddl_online_fwd_f32)
//
// (both in lddl_tpu/ops/flash_attention.py). Built at D=64 and 128, and
// the online forward at D=256 (fwd_body_wide: the reference's
// single-block regime never takes D > 128). The fp32 backward is
// attention_f32_bwd.cu.
//
// What they compute (per (batch*head) row, the bf16 forward's function,
// attention_fwd.cu, on fp32 operands, where the reference's cast of P to
// V's dtype is a no-op):
//   S = Q K^T * scale + bias, bias = 0 where kmask > 0 && kmask == qmask,
//       else -1e9 (fp32, added to the scaled score; never -inf);
//   walk the K/V tiles with a running max m, denominator l and an fp32
//   accumulator, each rescaled by corr = exp(m - m_new):
//   O = O corr + P V, P = exp(S - m_new);
//   O = O / max(l, 1e-30), LSE = m + log(max(l, 1e-30)).
// The single-block reference takes each row's max over all keys at once;
// in fp32 the tile walk differs from it in rounding only. expf and logf,
// not the fast-math intrinsics. No tile is skipped: padded query rows
// (qmask 0) see every key disallowed and spread over all L_pad keys, and a
// batch row masked entirely gives the uniform average, as in the
// reference. No atomics: every output element is written by one thread of
// one block, which sums in a fixed order, so two launches give
// bit-identical results. Layout: q/k/v/o [B*H, L_pad, D] fp32, masks int32
// [B, L_pad], LSE fp32 [B*H, L_pad]; L_pad a multiple of 128.
//
// What bounds them on this card: at bert_large's largest kernel bin (B=16,
// H=16, L_pad 512, D=64) the forward does 17.2 GFLOP of fp32 products
// against 135 MB of operands; three TF32 products each are 51.5 GFLOP,
// 0.104 ms at 494.7 TFLOP/s, against 0.26 ms of FFMA at 66.9 and 0.04 ms
// of bytes at 3.35 TB/s: the tensor cores bound it. At bart_base's three
// heads (B=8, H=3, L_pad 1024, D=256) the online forward does 25.8 GFLOP
// against 101 MB: 0.156 ms of 3xTF32 against 0.03 ms of bytes. At the TF32 peak a k8
// wgmma with both operands in shared memory reads 128 bytes a clock at
// N=64, the SM's whole shared-memory rate, so the score products run at
// N=64 here (the backward's N=32 needs 192).
//
// Design (the dQ body of attention_f32_bwd.cu without dP, with the online
// max and sum; the pieces are tf32x3_tiles.cuh's): items are queries (Q
// alone); the producer streams K and V tiles with their kmask slice. The
// split pass keeps K natural (hi and lo) for S = Q K^T, both operands
// K-major as they stand, and V only transposed (rows = D, K columns in
// the order 0 2 4 6 1 3 5 7) for P V. It is the largest part of a tile
// besides the products, so a thread issues its loads in batches before
// their stores (split_tile_batched), through a base aligned in the shared
// space (LDS/STS, not generic LD/ST): at bert_large's shape the split
// then costs 0.05 ms of 0.27 where the pairwise generic one cost 0.15 of
// 0.36 (NVIDIA H100, 700 W). Each warpgroup takes its 64 x TR score tile
// into registers (lo·hi, hi·lo, hi·hi), applies scale and bias there,
// takes each row's tile max over the quad of threads that holds the row,
// turns S into P = exp(S - m_new), folds P's row sums into the thread's
// part of l, and splits P into the tf32 A fragments of P V (m64n64k8
// over 64-column chunks of D). A tile's P V starts from zero
// and the threads compute O = O corr + P V in fp32: the tensor core's
// fp32 sums truncate. setmaxnreg moves registers from the producer
// warpgroup (24) to the consumers (240) at D=64. The epilogue divides by l
// and stores O and the LSE straight to device memory from registers.
// At D=256 the online forward runs fwd_body_wide (below), on the wide
// pieces of the backward pair at D=256.

#include <math.h>

#include "tf32x3_tiles.cuh"

namespace {

using namespace lddl_tf32x3;

// How the forward divides its work and its shared memory at head dim D.
// An item holds one operand (Q), so tiles are twice the backward's:
// - D=64: two consumer warpgroups, items of 128 rows (Q hi and lo: 64
//   KB), streamed tiles of 64 rows (K hi/lo 32 KB, V^T hi/lo 32 KB), two
//   landing stages of raw K and V (64 KB): 192 KB and the slices.
// - D=128: one consumer warpgroup, items of 64 rows (64 KB), tiles of 32
//   rows: the same bytes.
// - D=256 (the online forward): FwdWidePlan below.
// Registers a consumer thread at D=64: S 32, O 32, the tile's P V 32, P's
// hi/lo fragments 64.
template <int D>
struct FwdPlanOf {
  using type = Plan<D, D == 64 ? 2 : 1, D == 64 ? 64 : 32, 1, 1, 1, 1, 1>;
};

// At D=256 an item's 64 rows of Q take 128 KB in hi and lo, and O with a
// tile's partial product 256 fp32 registers a thread, past the 255 a
// thread may hold. So the wide body keeps Q in fp32 (64 KB) and splits
// each k8 slice of it into register fragments at its product
// (item_scores), and two consumer warpgroups share the item's 64 rows:
// warpgroup wg takes S's k8 steps [SK wg, SK wg + SK) (Q's panels 4 wg to
// 4 wg + 3 against the same panels of K), spread over NACC accumulators
// that each sum 8 steps from zero, and the two swap their partial tiles
// through shared memory (exchange_scores, into the lo panels of K that
// only the writer's products read). Both then hold S = half 0 + half 1
// (IEEE addition commutes: the same bits in both), and so the same m, l
// and P; each keeps two of D's four 64-column chunks of O (64 registers a
// thread; the tile's P V is taken a chunk at a time, 32 more: both
// chunks' at once spilled). No product is done twice. A tile's operands
// are V then K (operand 0 is transposed for P V, operand 1 stays natural
// for S; V's natural lo is never made). A small-N wgmma costs about the
// same whatever its N, so tiles are as wide as shared memory lets them
// be: 32 keys, in one landing stage, free once both halves of S are done
// (the next tile loads beside the exchange, P and P V). Shared memory: Q
// 64 KB, the stage (64 KB), K's lo (32 KB), V^T in hi and lo in two panel
// rows (64 KB): 225 KB with the slices and the barriers. 16-key tiles in
// two stages took 0.57 ms where these take 0.46 (NVIDIA H100, 700 W).
struct FwdWidePlan {
  static constexpr int D = 256;
  static constexpr int NWG = 2;                     // consumer warpgroups
  static constexpr int NC = 128 * NWG;              // consumer threads
  static constexpr int NTHREADS = NC + 128;         // + the producer's
  static constexpr int IROWS = 64;                  // rows of a work item
  static constexpr int TR = 32;                     // rows of a K/V tile
  static constexpr int DP = D / PANEL_F32;          // panels of a D-wide row
  static constexpr int NCH = 2;                     // chunks a warpgroup keeps
  static constexpr int ROPS = 1;                    // operands of an item: Q
  static constexpr int NT = 1;                      // V transposed
  static constexpr int NAT0 = 1;                    // K natural
  static constexpr int SK = D / 16;                 // k8 steps a warpgroup
  static constexpr int G = 2;                       // k8 steps a score batch
  static constexpr int NACC = 2;                    // score accumulators
  static constexpr int SLICES = 1;                  // kmask
  static constexpr int SLICE = TR * 4;              // bytes of a slice
  static constexpr int LS = 1;                      // one stage
  static constexpr int RES_P = IROWS * ROW_BYTES;   // an item panel
  static constexpr int ITEM_OP = DP * RES_P;        // Q, fp32
  static constexpr int TILE_P = TR * ROW_BYTES;     // a streamed panel
  static constexpr int RES = ROPS * ITEM_OP;
  static constexpr int LAND = 2 * DP * TILE_P;      // V and K
  static constexpr int NAT = DP * TILE_P;           // K's lo
  static constexpr int TPOSE =                      // V^T, hi and lo
      2 * TR / PANEL_F32 * D * ROW_BYTES;
  static constexpr int XCH = DP / 2 * TILE_P;       // half of K's lo panels
  static constexpr size_t SMEM = RES + NAT + TPOSE + LS * LAND +
                                 (LS + 1) * SLICES * SLICE +
                                 (2 * LS + 2) * 8 + 1024;
  static_assert(2 * TR % PANEL_F32 == 0,
                "V^T's hi and lo fill whole panel rows");
  static_assert(NWG * SK * 8 == D, "the warpgroups' steps cover D once");
  static_assert(SK / NACC == 8, "8 k8 steps an accumulator");
  static_assert(SMEM <= 232448, "227 KB of shared memory");
  static_assert(NWG * CONSUMER_REGS + PRODUCER_REGS <= 504,
                "setmaxnreg's sum a thread slot (512 hangs)");
};

template <>
struct FwdPlanOf<256> {
  using type = FwdWidePlan;
};

template <int D>
using FwdPlan = typename FwdPlanOf<D>::type;

// o = o corr + part for the thread's rows r (corr c0) and r + 8 (c1) of
// an accumulator chunk, once the products into part are waited for.
__device__ __forceinline__ void rescale_add(float (&o)[32], float (&part)[32],
                                            float c0, float c1) {
  fence_f32(part);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[4 * j + 0] = o[4 * j + 0] * c0 + part[4 * j + 0];
    o[4 * j + 1] = o[4 * j + 1] * c0 + part[4 * j + 1];
    o[4 * j + 2] = o[4 * j + 2] * c1 + part[4 * j + 2];
    o[4 * j + 3] = o[4 * j + 3] * c1 + part[4 * j + 3];
  }
}

// The mainloop: per work item (IROWS queries of one batch*head), walk the
// K/V tiles. The maps are the kernel's __grid_constant__ parameters.
template <int D>
__device__ __forceinline__ void fwd_body(
    uint8_t* smem_raw, const CUtensorMap* map_q, const CUtensorMap* map_k,
    const CUtensorMap* map_v, const int* __restrict__ kmask,
    const int* __restrict__ qmask, float* __restrict__ out,
    float* __restrict__ lse, int BH, int L, int H, float scale) {
  using P = FwdPlan<D>;
  constexpr int TR = P::TR, KC = TR / 8, NCH = P::NCH;
  // Aligned by pointer arithmetic on the shared array, so that the split's
  // loads and stores stay in the shared space (LDS/STS).
  const Smem<P> sm(align_1024_shared(smem_raw));
  const int nblk = L / P::IROWS, nitems = BH * nblk, ntiles = L / TR;

  init_barriers(sm);

  if (threadIdx.x >= P::NC) {
    // Producer: Q rows an item, then the K/V ring.
    if constexpr (P::NWG == 2) setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != P::NC) return;
    produce(sm, map_q, nullptr, map_k, map_v, BH, L, H,
            [&](int b, int, int col, uint8_t* sl, uint64_t* bar) {
              bulk_load(sl, kmask + (size_t)b * L + col, P::SLICE, bar);
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
  float oacc[NCH][32], part[NCH][32], sc[TR / 2];
  uint32_t phi[KC][4], plo[KC][4];
#pragma unroll
  for (int i = 0; i < TR / 2; ++i) sc[i] = 0.0f;
  int t = 0;
  for (int item = blockIdx.x, j = 0; item < nitems;
       item += gridDim.x, ++j) {
    const int bh = item / nblk, q0 = (item % nblk) * P::IROWS, b = bh / H;
    const size_t qrow = (size_t)bh * L + q0 + 64 * wg;
    const int qm0 = qmask[(size_t)b * L + q0 + 64 * wg + r];
    const int qm1 = qmask[(size_t)b * L + q0 + 64 * wg + r + 8];
    // Rows r and r + 8: the running max, and the thread's part of the
    // running denominator (its columns; the quad's sum is l).
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc)
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[cc][i] = 0.0f;
    mbar_wait(sm.res_full, j & 1);
    split_item(sm, wg, wtid);
    fence_proxy_async();
    named_barrier(2 + wg, 128);

    for (int i = 0; i < ntiles; ++i, ++t) {
      const int s = t % P::LS;
      mbar_wait(&sm.full[s], (t / P::LS) & 1);
      named_barrier(1, P::NC);    // every product of the last tile is done
      split_tile_batched(sm, s, threadIdx.x);
      mbar_arrive(&sm.empty[s]);
      fence_proxy_async();
      named_barrier(1, P::NC);    // the split tile is written

      // S = Q K^T (64 queries x TR keys).
      fence_f32(sc);
      wgmma_fence();
      score_products(sm, 0, wg, sc);
      wgmma_commit();
      wgmma_wait<0>();
      fence_f32(sc);

      // S scale + bias, the rows' new max; corr = exp(m - m_new) is 0 on
      // the first tile, where m is still -inf.
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        const int2 k = *reinterpret_cast<const int2*>(km + 8 * jj + c);
        sc[4 * jj + 0] = sc[4 * jj + 0] * scale + bias(k.x, qm0);
        sc[4 * jj + 1] = sc[4 * jj + 1] * scale + bias(k.y, qm0);
        sc[4 * jj + 2] = sc[4 * jj + 2] * scale + bias(k.x, qm1);
        sc[4 * jj + 3] = sc[4 * jj + 3] * scale + bias(k.y, qm1);
        mx0 = fmaxf(mx0, fmaxf(sc[4 * jj + 0], sc[4 * jj + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * jj + 2], sc[4 * jj + 3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float corr0 = expf(m0 - mx0), corr1 = expf(m1 - mx1);
      m0 = mx0;
      m1 = mx1;

      // P = exp(S - m_new), its row sums, and its tf32 A fragments.
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        const float p0 = expf(sc[4 * jj + 0] - mx0);
        const float p1 = expf(sc[4 * jj + 1] - mx0);
        const float p2 = expf(sc[4 * jj + 2] - mx1);
        const float p3 = expf(sc[4 * jj + 3] - mx1);
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        to_frag(p0, p1, p2, p3, phi[jj], plo[jj]);
      }
      l0 = l0 * corr0 + sum0;
      l1 = l1 * corr1 + sum1;

      // O = O corr + P V (the transposed V), the tile's product added by
      // the threads.
      fence_frags(phi);
      fence_frags(plo);
#pragma unroll
      for (int cc = 0; cc < NCH; ++cc) fence_f32(part[cc]);
      wgmma_fence();
      contract_products(sm, 1, part, phi, plo);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int cc = 0; cc < NCH; ++cc)
        rescale_add(oacc[cc], part[cc], corr0, corr1);
      fence_frags(phi);
      fence_frags(plo);
    }

    // The item's rows are dead: free the item buffer, then O / l and the
    // LSE.
    mbar_arrive(sm.res_empty);
    l0 = fmaxf(quad_sum(l0), 1e-30f);
    l1 = fmaxf(quad_sum(l1), 1e-30f);
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        oacc[cc][4 * jj + 0] /= l0;
        oacc[cc][4 * jj + 1] /= l0;
        oacc[cc][4 * jj + 2] /= l1;
        oacc[cc][4 * jj + 3] /= l1;
      }
      store_chunk<D>(out, qrow, cc, r, c, oacc[cc]);
    }
    if (wtid % 4 == 0) {
      lse[qrow + r] = m0 + logf(l0);
      lse[qrow + r + 8] = m1 + logf(l1);
    }
  }
}

// The online forward at D=256 (FwdWidePlan): per work item (64 queries of
// one batch*head), walk the K/V tiles. Each warpgroup computes half of
// S's k8 steps, the two halves are swapped and added, and each warpgroup
// adds P V to its two chunks of O.
__device__ __forceinline__ void fwd_body_wide(
    uint8_t* smem_raw, const CUtensorMap* map_q, const CUtensorMap* map_k,
    const CUtensorMap* map_v, const int* __restrict__ kmask,
    const int* __restrict__ qmask, float* __restrict__ out,
    float* __restrict__ lse, int BH, int L, int H, float scale) {
  using P = FwdWidePlan;
  constexpr int TR = P::TR, KC = TR / 8, NCH = P::NCH;
  const Smem<P> sm(align_1024_shared(smem_raw));
  const int nblk = L / P::IROWS, nitems = BH * nblk, ntiles = L / TR;

  init_barriers(sm);

  if (threadIdx.x >= P::NC) {
    // Producer: Q rows an item, then the V/K ring.
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != P::NC) return;
    produce(sm, map_q, nullptr, map_v, map_k, BH, L, H,
            [&](int b, int, int col, uint8_t* sl, uint64_t* bar) {
              bulk_load(sl, kmask + (size_t)b * L + col, P::SLICE, bar);
            });
    return;
  }

  // Consumers: both warpgroups hold the item's query rows; a thread holds
  // rows r and r + 8 (queries) and columns 8j + c, 8j + c + 1 (keys) of
  // the score tiles, and its warpgroup's chunks NCH wg + cc of O.
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128;
  const int r = 16 * (wtid / 32) + (wtid % 32) / 4, c = 2 * (wtid % 4);
  const int* km = reinterpret_cast<const int*>(
      sm.slices + P::LS * P::SLICES * P::SLICE);
  float oacc[NCH][32], part[1][32], mine[TR / 2], other[TR / 2];
  uint32_t phi[KC][4], plo[KC][4];
  int t = 0;
  for (int item = blockIdx.x, j = 0; item < nitems;
       item += gridDim.x, ++j) {
    const int bh = item / nblk, q0 = (item % nblk) * P::IROWS, b = bh / H;
    const size_t qrow = (size_t)bh * L + q0;
    const int qm0 = qmask[(size_t)b * L + q0 + r];
    const int qm1 = qmask[(size_t)b * L + q0 + r + 8];
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc)
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[cc][i] = 0.0f;
    mbar_wait(sm.res_full, j & 1);
    permute_item(sm, 0, wg * P::SK / 4, wtid);
    named_barrier(2 + wg, 128);

    for (int i = 0; i < ntiles; ++i, ++t) {
      mbar_wait(&sm.full[0], t & 1);
      named_barrier(1, P::NC);    // every read of the last tile is done
      split_tile_inplace(sm, 0, threadIdx.x);
      fence_proxy_async();
      named_barrier(1, P::NC);    // the split tile is written

      // The warpgroup's half of S = Q K^T (64 queries x TR keys); the
      // stage is free once both halves are done, and the next tile loads
      // beside the rest.
      item_scores(sm, 0, 1, wg * P::SK, 0, wtid, mine);
      mbar_arrive(&sm.empty[0]);
      exchange_scores(sm, wg, wtid, mine, other);

      // S = half 0 + half 1, scale + bias, the rows' new max; corr =
      // exp(m - m_new) is 0 on the first tile, where m is still -inf.
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        const int2 k = *reinterpret_cast<const int2*>(km + 8 * jj + c);
        mine[4 * jj + 0] = (mine[4 * jj + 0] + other[4 * jj + 0]) * scale +
                           bias(k.x, qm0);
        mine[4 * jj + 1] = (mine[4 * jj + 1] + other[4 * jj + 1]) * scale +
                           bias(k.y, qm0);
        mine[4 * jj + 2] = (mine[4 * jj + 2] + other[4 * jj + 2]) * scale +
                           bias(k.x, qm1);
        mine[4 * jj + 3] = (mine[4 * jj + 3] + other[4 * jj + 3]) * scale +
                           bias(k.y, qm1);
        mx0 = fmaxf(mx0, fmaxf(mine[4 * jj + 0], mine[4 * jj + 1]));
        mx1 = fmaxf(mx1, fmaxf(mine[4 * jj + 2], mine[4 * jj + 3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float corr0 = expf(m0 - mx0), corr1 = expf(m1 - mx1);
      m0 = mx0;
      m1 = mx1;

      // P = exp(S - m_new), its row sums, and its tf32 A fragments.
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        const float p0 = expf(mine[4 * jj + 0] - mx0);
        const float p1 = expf(mine[4 * jj + 1] - mx0);
        const float p2 = expf(mine[4 * jj + 2] - mx1);
        const float p3 = expf(mine[4 * jj + 3] - mx1);
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        to_frag(p0, p1, p2, p3, phi[jj], plo[jj]);
      }
      l0 = l0 * corr0 + sum0;
      l1 = l1 * corr1 + sum1;

      // O = O corr + P V (V^T), the warpgroup's chunks one at a time (a
      // chunk's 32 registers of the tile's product, not both chunks'),
      // the tile's product added by the threads.
      fence_frags(phi);
      fence_frags(plo);
#pragma unroll
      for (int cc = 0; cc < NCH; ++cc) {
        undef_f32(part[0]);
        wgmma_fence();
        contract_wide(sm, 0, NCH * wg + cc, part, phi, plo);
        wgmma_commit();
        wgmma_wait<0>();
        rescale_add(oacc[cc], part[0], corr0, corr1);
      }
      fence_frags(phi);
      fence_frags(plo);
    }

    // The item's rows are dead: free the item buffer, then O / l and the
    // LSE (warpgroup 0's; both hold the same l and m).
    mbar_arrive(sm.res_empty);
    l0 = fmaxf(quad_sum(l0), 1e-30f);
    l1 = fmaxf(quad_sum(l1), 1e-30f);
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        oacc[cc][4 * jj + 0] /= l0;
        oacc[cc][4 * jj + 1] /= l0;
        oacc[cc][4 * jj + 2] /= l1;
        oacc[cc][4 * jj + 3] /= l1;
      }
      store_chunk<P::D>(out, qrow, NCH * wg + cc, r, c, oacc[cc]);
    }
    if (wg == 0 && wtid % 4 == 0) {
      lse[qrow + r] = m0 + logf(l0);
      lse[qrow + r + 8] = m1 + logf(l1);
    }
  }
}

// The __global__ kernels: the two regimes run the same body under their
// own names, so the profiler tells them apart.
#define LDDL_FWD_KERNEL(name)                                               \
  template <int D>                                                          \
  __global__ void __launch_bounds__(FwdPlan<D>::NTHREADS, 1) name(          \
      const __grid_constant__ CUtensorMap map_q,                            \
      const __grid_constant__ CUtensorMap map_k,                            \
      const __grid_constant__ CUtensorMap map_v,                            \
      const int* __restrict__ kmask, const int* __restrict__ qmask,         \
      float* __restrict__ o, float* __restrict__ lse, int BH, int L, int H, \
      float scale) {                                                        \
    extern __shared__ uint8_t smem_raw[];                                   \
    if constexpr (D == 256)                                                 \
      fwd_body_wide(smem_raw, &map_q, &map_k, &map_v, kmask, qmask, o, lse, \
                    BH, L, H, scale);                                       \
    else                                                                    \
      fwd_body<D>(smem_raw, &map_q, &map_k, &map_v, kmask, qmask, o, lse,   \
                  BH, L, H, scale);                                         \
  }

LDDL_FWD_KERNEL(onekv_fwd_f32_kernel)
LDDL_FWD_KERNEL(online_fwd_f32_kernel)

#undef LDDL_FWD_KERNEL

// Tensor maps over q, k, v ([BH * L, D] fp32, boxes of TR rows), the
// persistent grid (at most one block per SM), and the launch's error.
template <int D, typename Kernel>
int launch(Kernel kernel, const void* q, const void* k, const void* v,
           const void* km, const void* qm, void* o, void* lse, int BH,
           int L, int H, float scale, cudaStream_t stream) {
  using P = FwdPlan<D>;
  if (!shape_ok(BH, L, 128)) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 3 && err == cudaSuccess; ++i)
    err = make_map_f32(&maps[i], ptrs[i], (uint64_t)BH * L, D, P::TR);
  int grid = 0;
  if (err == cudaSuccess) err = persistent_grid<P>(kernel, BH, L, &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, P::NTHREADS, P::SMEM, stream>>>(
      maps[0], maps[1], maps[2], (const int*)km, (const int*)qm, (float*)o,
      (float*)lse, BH, L, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes), the bf16 forward entry points'
// arguments under an _f32 name. Each returns the cudaError_t of its
// launch: 0 on success, cudaErrorInvalidValue at a head dim that is not
// built here. Inputs are checked by the Python wrapper.
extern "C" {

int lddl_onekv_fwd_f32(const void* q, const void* k, const void* v,
                       const void* kmask, const void* qmask, void* o,
                       void* lse, int BH, int L, int H, int D, float scale,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(onekv_fwd_f32_kernel<64>, q, k, v, kmask, qmask, o,
                      lse, BH, L, H, scale, s);
  if (D == 128)
    return launch<128>(onekv_fwd_f32_kernel<128>, q, k, v, kmask, qmask, o,
                       lse, BH, L, H, scale, s);
  return (int)cudaErrorInvalidValue;
}

int lddl_online_fwd_f32(const void* q, const void* k, const void* v,
                        const void* kmask, const void* qmask, void* o,
                        void* lse, int BH, int L, int H, int D, float scale,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(online_fwd_f32_kernel<64>, q, k, v, kmask, qmask, o,
                      lse, BH, L, H, scale, s);
  if (D == 128)
    return launch<128>(online_fwd_f32_kernel<128>, q, k, v, kmask, qmask,
                       o, lse, BH, L, H, scale, s);
  if (D == 256)
    return launch<256>(online_fwd_f32_kernel<256>, q, k, v, kmask, qmask,
                       o, lse, BH, L, H, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
