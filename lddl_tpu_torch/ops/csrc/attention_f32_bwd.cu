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
// (all in lddl_tpu/ops/flash_attention.py). Built at D=64 and 128, and
// the online pair at D=256 (WidePlan: the reference's single-block regime
// never takes D > 128). The fp32 forwards are attention_f32_fwd.cu.
//
// What they compute: the bf16 backward's function (online_attention_bwd.cu)
// on fp32 operands:
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
// What bounds them on this card: at the BART path's shape (B=8, H=12,
// L_pad 1024, D=64) dQ recomputes S and dP and does dS K, 38.7 GFLOP of
// fp32 products, dK/dV 51.5; three TF32 products each are 116 and 155
// GFLOP, 0.23 and 0.31 ms at 494.7 TFLOP/s, against 0.58 and 0.77 ms of
// FFMA at 66.9. Operands are 31-38 MB (~0.01 ms at 3.35 TB/s): the tensor
// cores bound them. bart_base at three heads (B=8, H=3, D=256) does the
// same products. At the TF32 peak a k8 wgmma with both operands in
// shared memory reads 128 bytes a clock at N=64 (the SM's whole
// shared-memory rate) and 192 at N=32, so the score products are bound by
// shared memory before the tensor cores.
//
// Design (the bf16 backward's, online_attention_bwd.cu, on tf32; the
// pieces are tf32x3_tiles.cuh's): items are keys (dK/dV: K and V, the
// Q/dO tiles streamed with their qmask, LSE and delta slices) or queries
// (dQ: Q and dO, the K/V tiles streamed with their kmask slice). Both
// streamed operands stay natural for the two score products (S and dP);
// the contracting products take the transposed dO and Q (dK/dV) or K
// (dQ). Each warpgroup applies bias, exp and dS to its score tiles in
// registers, splits P and dS there into A fragments, and adds each tile's
// contracting products to its accumulators.
// The split runs between the products, by every consumer thread. Two
// other placements measured no faster on this card: in the producer
// warpgroup beside the products (its four warps split more slowly than
// the consumers' eight, and gate both consumer warpgroups), and each half
// of the split tile beside the other half's products (the split and the
// score products share the shared-memory rate). setmaxnreg moves
// registers from the producer warpgroup (24) to the consumers (240) at
// D=64. The epilogue stores the fp32 accumulators straight to device
// memory.

#include <math.h>

#include "tf32x3_tiles.cuh"

namespace {

using namespace lddl_tf32x3;

// How a body (DKV: the dK/dV body, else the dQ body) divides its work and
// its shared memory at head dim D. Each streamed tile is kept in two
// layouts, so shared memory sets the sizes:
// - D=64: two consumer warpgroups, items of 128 rows (their hi and lo
//   take 128 KB), streamed tiles of 32 rows (split: 64 KB for dK/dV, 48
//   KB for dQ), two landing stages of 16 KB: 226 KB for dK/dV.
// - D=128: one consumer warpgroup, items of 64 rows (128 KB), tiles of 16
//   rows (the same bytes as at D=64).
// - D=256 (the online pair): WidePlan below.
template <int D, bool DKV>
struct BwdPlanOf {
  using type = Plan<D, D == 64 ? 2 : 1, D == 64 ? 32 : 16, 2, 2, 0,
                    DKV ? 2 : 1, DKV ? 3 : 1>;
};

// At D=256 an item's 64 rows would take 256 KB in hi and lo, so the wide
// bodies keep the item in fp32 (Q and dO, or K and V: 128 KB) and split
// each k8 slice of it into register fragments at its product, on
// tf32x3_tiles.cuh's wide pieces. Two consumer warpgroups both hold the
// item's 64 rows; warpgroup 0 takes S (Q K^T, or K Q^T for dK/dV) and
// warpgroup 1 dP (dO V^T, or V dO^T), each with the item's operand as the
// register A and the tile's as B, the k8 steps spread over NACC
// accumulators, each from zero; they swap the two tiles through shared
// memory, both compute P and dS, and each keeps two of D's four 64-column
// chunks of the outputs (dQ: 64 registers a thread; dK and dV: 128). No
// score product is done twice, and no output is summed across
// warpgroups. The tile widths are what shared memory leaves; at these N
// the score products' count of wgmma, more than their work, sets their
// time (chip_f32_phases.py's variant ndouble). Shared memory:
// - dQ: K/V tiles of 16 rows, one landing stage (32 KB, hi after the
//   split in place), their lo halves (32 KB) and K^T in hi and lo (32
//   KB): 224 KB with the item. The producer loads the next tile once both
//   score products are done, beside the exchange, P, dS and dS K.
// - dK/dV: Q/dO tiles of 8 rows, two landing stages (16 KB each), the lo
//   halves (16 KB) and Q^T and dO^T in hi and lo in one panel row (32
//   KB): 208 KB.
template <bool DKV>
struct WidePlan {
  static constexpr int D = 256;
  static constexpr int NWG = 2;                     // consumer warpgroups
  static constexpr int NC = 128 * NWG;              // consumer threads
  static constexpr int NTHREADS = NC + 128;         // + the producer's
  static constexpr int IROWS = 64;                  // rows of a work item
  static constexpr int TR = DKV ? 8 : 16;           // rows of a streamed tile
  static constexpr int DP = D / PANEL_F32;          // panels of a D-wide row
  static constexpr int NCH = 2;                     // chunks a warpgroup keeps
  static constexpr int ROPS = 2;                    // operands of an item
  static constexpr int NT = DKV ? 2 : 1;            // operands transposed
  static constexpr int NAT0 = 0;                    // all kept natural too
  static constexpr int SK = D / 8;                  // k8 steps a score tile
  static constexpr int G = 2;                       // k8 steps a score batch
  static constexpr int NACC = 4;                    // score accumulators
  static constexpr int SLICES = DKV ? 3 : 1;        // row slices a tile
  static constexpr int SLICE = TR * 4;              // bytes of a slice
  static constexpr int LS = DKV ? 2 : 1;            // landing stages
  static constexpr int RES_P = IROWS * ROW_BYTES;   // an item panel
  static constexpr int ITEM_OP = DP * RES_P;        // an item operand, fp32
  static constexpr int TILE_P = TR * ROW_BYTES;     // a streamed panel
  static constexpr int RES = ROPS * ITEM_OP;
  static constexpr int LAND = 2 * DP * TILE_P;      // a stage: two tiles
  static constexpr int NAT = LAND;                  // their lo halves
  static constexpr int TPOSE = D * ROW_BYTES;       // the transposed panel
  static constexpr int XCH = DP * TILE_P;           // an operand's lo half
  static constexpr size_t SMEM = RES + NAT + TPOSE + LS * LAND +
                                 (LS + 1) * SLICES * SLICE +
                                 (2 * LS + 2) * 8 + 1024;
  static_assert(NT * 2 * TR == PANEL_F32,
                "the transposed operands' hi and lo fill one panel row");
  static_assert(SMEM <= 232448, "227 KB of shared memory");
  static_assert(NWG * CONSUMER_REGS + PRODUCER_REGS <= 504,
                "setmaxnreg's sum a thread slot (512 hangs)");
};

template <bool DKV>
struct BwdPlanOf<256, DKV> {
  using type = WidePlan<DKV>;
};

template <int D, bool DKV>
using BwdPlan = typename BwdPlanOf<D, DKV>::type;

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
  using P = BwdPlan<D, true>;
  constexpr int TR = P::TR, KC = TR / 8, NCH = P::NCH;
  const Smem<P> sm(align_1024(smem_raw));
  const int nblk = L / P::IROWS, nitems = BH * nblk, ntiles = L / TR;

  init_barriers(sm);

  if (threadIdx.x >= P::NC) {
    // Producer: K and V rows an item, then the Q/dO ring.
    if constexpr (P::NWG == 2) setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != P::NC) return;
    produce(sm, map_k, map_v, map_q, map_do, BH, L, H,
            [&](int b, int row, int col, uint8_t* sl, uint64_t* bar) {
              bulk_load(sl, qmask + (size_t)b * L + col, P::SLICE, bar);
              bulk_load(sl + P::SLICE, lse + row, P::SLICE, bar);
              bulk_load(sl + 2 * P::SLICE, delta + row, P::SLICE, bar);
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
    split_item(sm, wg, wtid);
    fence_proxy_async();
    named_barrier(2 + wg, 128);

    for (int i = 0; i < ntiles; ++i, ++t) {
      const int s = t % P::LS;
      mbar_wait(&sm.full[s], (t / P::LS) & 1);
      named_barrier(1, P::NC);    // every product of the last tile is done
      split_tile(sm, s, threadIdx.x);
      mbar_arrive(&sm.empty[s]);
      fence_proxy_async();
      named_barrier(1, P::NC);    // the split tile is written

      // S^T = K Q^T and dP^T = V dO^T (64 keys x TR queries).
      fence_f32(st);
      fence_f32(dpt);
      wgmma_fence();
      score_products(sm, 0, wg, st);
      score_products(sm, 1, wg, dpt);
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
      contract_products(sm, 1, part, phi, plo);
      wgmma_commit();
      wgmma_wait<0>();
      add_parts(dvacc, part);
      wgmma_fence();
      contract_products(sm, 0, part, shi, slo);
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
  using P = BwdPlan<D, false>;
  constexpr int TR = P::TR, KC = TR / 8, NCH = P::NCH;
  const Smem<P> sm(align_1024(smem_raw));
  const int nblk = L / P::IROWS, nitems = BH * nblk, ntiles = L / TR;

  init_barriers(sm);

  if (threadIdx.x >= P::NC) {
    // Producer: Q and dO rows an item, then the K/V ring.
    if constexpr (P::NWG == 2) setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != P::NC) return;
    produce(sm, map_q, map_do, map_k, map_v, BH, L, H,
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
    split_item(sm, wg, wtid);
    fence_proxy_async();
    named_barrier(2 + wg, 128);

    for (int i = 0; i < ntiles; ++i, ++t) {
      const int s = t % P::LS;
      mbar_wait(&sm.full[s], (t / P::LS) & 1);
      named_barrier(1, P::NC);    // every product of the last tile is done
      split_tile(sm, s, threadIdx.x);
      mbar_arrive(&sm.empty[s]);
      fence_proxy_async();
      named_barrier(1, P::NC);    // the split tile is written

      // S = Q K^T and dP = dO V^T (64 queries x TR keys).
      fence_f32(sc);
      fence_f32(dp);
      wgmma_fence();
      score_products(sm, 0, wg, sc);
      score_products(sm, 1, wg, dp);
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
      contract_products(sm, 0, part, shi, slo);
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

// The dK/dV mainloop at D=256 (WidePlan<true>): per work item (64 keys of
// one batch*head), walk the Q/dO tiles. Warpgroup 0 computes S^T = K Q^T,
// warpgroup 1 dP^T = V dO^T; after the swap both hold both tiles and
// each adds P^T dO and dS^T Q to its two chunks of dV and dK.
__device__ __forceinline__ void dkv_body_wide(
    uint8_t* smem_raw, const CUtensorMap* map_q, const CUtensorMap* map_k,
    const CUtensorMap* map_v, const CUtensorMap* map_do,
    const int* __restrict__ kmask, const int* __restrict__ qmask,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int BH, int L, int H,
    float scale) {
  using P = WidePlan<true>;
  constexpr int TR = P::TR, KC = TR / 8, NCH = P::NCH;
  const Smem<P> sm(align_1024_shared(smem_raw));
  const int nblk = L / P::IROWS, nitems = BH * nblk, ntiles = L / TR;

  init_barriers(sm);

  if (threadIdx.x >= P::NC) {
    // Producer: K and V rows an item, then the Q/dO ring.
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != P::NC) return;
    produce(sm, map_k, map_v, map_q, map_do, BH, L, H,
            [&](int b, int row, int col, uint8_t* sl, uint64_t* bar) {
              bulk_load(sl, qmask + (size_t)b * L + col, P::SLICE, bar);
              bulk_load(sl + P::SLICE, lse + row, P::SLICE, bar);
              bulk_load(sl + 2 * P::SLICE, delta + row, P::SLICE, bar);
            });
    return;
  }

  // Consumers: both warpgroups hold the item's key rows; a thread holds
  // rows r and r + 8 (keys) and columns c and c + 1 (queries) of the
  // score tiles, and its warpgroup's chunks NCH wg + cc of dK and dV.
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128;
  const int r = 16 * (wtid / 32) + (wtid % 32) / 4, c = 2 * (wtid % 4);
  const int* qm = reinterpret_cast<const int*>(
      sm.slices + P::LS * P::SLICES * P::SLICE);
  const float* ql = reinterpret_cast<const float*>(qm + TR);
  const float* qd = ql + TR;
  float dkacc[NCH][32], dvacc[NCH][32], part[NCH][32];
  float mine[TR / 2], other[TR / 2];
  uint32_t phi[KC][4], plo[KC][4], shi[KC][4], slo[KC][4];
  int t = 0;
  for (int item = blockIdx.x, j = 0; item < nitems;
       item += gridDim.x, ++j) {
    const int bh = item / nblk, k0 = (item % nblk) * P::IROWS, b = bh / H;
    const size_t krow = (size_t)bh * L + k0;
    const int km0 = kmask[(size_t)b * L + k0 + r];
    const int km1 = kmask[(size_t)b * L + k0 + r + 8];
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc)
#pragma unroll
      for (int i = 0; i < 32; ++i) dkacc[cc][i] = dvacc[cc][i] = 0.0f;
    mbar_wait(sm.res_full, j & 1);
    permute_item(sm, wg, 0, wtid);
    named_barrier(2 + wg, 128);

    for (int i = 0; i < ntiles; ++i, ++t) {
      const int s = t % P::LS;
      mbar_wait(&sm.full[s], (t / P::LS) & 1);
      named_barrier(1, P::NC);    // every read of the last tile is done
      split_tile_inplace(sm, s, threadIdx.x);
      fence_proxy_async();
      named_barrier(1, P::NC);    // the split tile is written

      // S^T (warpgroup 0) or dP^T (1), 64 keys x TR queries; the stage
      // is free once both are done.
      item_scores(sm, wg, wg, 0, s, wtid, mine);
      mbar_arrive(&sm.empty[s]);
      exchange_scores(sm, wg, wtid, mine, other);

      // P^T = exp(S^T scale + bias - LSE), dS^T = P^T (dP^T - delta)
      // scale, each split into tf32 A fragments.
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        float st[4], dpt[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[e] = wg == 0 ? mine[4 * jj + e] : other[4 * jj + e];
          dpt[e] = wg == 0 ? other[4 * jj + e] : mine[4 * jj + e];
        }
        const int2 m = *reinterpret_cast<const int2*>(qm + 8 * jj + c);
        const float2 l = *reinterpret_cast<const float2*>(ql + 8 * jj + c);
        const float2 d = *reinterpret_cast<const float2*>(qd + 8 * jj + c);
        const float p0 = expf(st[0] * scale + bias(km0, m.x) - l.x);
        const float p1 = expf(st[1] * scale + bias(km0, m.y) - l.y);
        const float p2 = expf(st[2] * scale + bias(km1, m.x) - l.x);
        const float p3 = expf(st[3] * scale + bias(km1, m.y) - l.y);
        to_frag(p0, p1, p2, p3, phi[jj], plo[jj]);
        to_frag(p0 * (dpt[0] - d.x) * scale, p1 * (dpt[1] - d.y) * scale,
                p2 * (dpt[2] - d.x) * scale, p3 * (dpt[3] - d.y) * scale,
                shi[jj], slo[jj]);
      }

      // dV += P^T dO, then dK += dS^T Q (dO^T and Q^T), the warpgroup's
      // chunks, each a tile's partial product added by the threads.
      fence_frags(phi);
      fence_frags(plo);
      fence_frags(shi);
      fence_frags(slo);
#pragma unroll
      for (int cc = 0; cc < NCH; ++cc) undef_f32(part[cc]);
      wgmma_fence();
      contract_wide(sm, 1, NCH * wg, part, phi, plo);
      wgmma_commit();
      wgmma_wait<0>();
      add_parts(dvacc, part);
#pragma unroll
      for (int cc = 0; cc < NCH; ++cc) undef_f32(part[cc]);
      wgmma_fence();
      contract_wide(sm, 0, NCH * wg, part, shi, slo);
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
      store_chunk<P::D>(dk, krow, NCH * wg + cc, r, c, dkacc[cc]);
      store_chunk<P::D>(dv, krow, NCH * wg + cc, r, c, dvacc[cc]);
    }
  }
}

// The dQ mainloop at D=256 (WidePlan<false>): per work item (64 queries of
// one batch*head), walk the K/V tiles. Warpgroup 0 computes S = Q K^T,
// warpgroup 1 dP = dO V^T; after the swap each adds dS K to its two
// chunks of dQ.
__device__ __forceinline__ void dq_body_wide(
    uint8_t* smem_raw, const CUtensorMap* map_q, const CUtensorMap* map_k,
    const CUtensorMap* map_v, const CUtensorMap* map_do,
    const int* __restrict__ kmask, const int* __restrict__ qmask,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int BH, int L, int H, float scale) {
  using P = WidePlan<false>;
  constexpr int TR = P::TR, KC = TR / 8, NCH = P::NCH;
  const Smem<P> sm(align_1024_shared(smem_raw));
  const int nblk = L / P::IROWS, nitems = BH * nblk, ntiles = L / TR;

  init_barriers(sm);

  if (threadIdx.x >= P::NC) {
    // Producer: Q and dO rows an item, then the K/V ring.
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != P::NC) return;
    produce(sm, map_q, map_do, map_k, map_v, BH, L, H,
            [&](int b, int, int col, uint8_t* sl, uint64_t* bar) {
              bulk_load(sl, kmask + (size_t)b * L + col, P::SLICE, bar);
            });
    return;
  }

  // Consumers: both warpgroups hold the item's query rows; a thread holds
  // rows r and r + 8 (queries) and columns 8j + c, 8j + c + 1 (keys) of
  // the score tiles, and its warpgroup's chunks NCH wg + cc of dQ.
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128;
  const int r = 16 * (wtid / 32) + (wtid % 32) / 4, c = 2 * (wtid % 4);
  const int* km = reinterpret_cast<const int*>(
      sm.slices + P::LS * P::SLICES * P::SLICE);
  float dqacc[NCH][32], part[NCH][32], mine[TR / 2], other[TR / 2];
  uint32_t shi[KC][4], slo[KC][4];
  int t = 0;
  for (int item = blockIdx.x, j = 0; item < nitems;
       item += gridDim.x, ++j) {
    const int bh = item / nblk, q0 = (item % nblk) * P::IROWS, b = bh / H;
    const size_t qrow = (size_t)bh * L + q0;
    const int qm0 = qmask[(size_t)b * L + q0 + r];
    const int qm1 = qmask[(size_t)b * L + q0 + r + 8];
    const float lse0 = lse[qrow + r], lse1 = lse[qrow + r + 8];
    const float dl0 = delta[qrow + r], dl1 = delta[qrow + r + 8];
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc)
#pragma unroll
      for (int i = 0; i < 32; ++i) dqacc[cc][i] = 0.0f;
    mbar_wait(sm.res_full, j & 1);
    permute_item(sm, wg, 0, wtid);
    named_barrier(2 + wg, 128);

    for (int i = 0; i < ntiles; ++i, ++t) {
      const int s = t % P::LS;
      mbar_wait(&sm.full[s], (t / P::LS) & 1);
      named_barrier(1, P::NC);    // every read of the last tile is done
      split_tile_inplace(sm, s, threadIdx.x);
      fence_proxy_async();
      named_barrier(1, P::NC);    // the split tile is written

      // S (warpgroup 0) or dP (1), 64 queries x TR keys; the stage is
      // free once both are done, and the next tile loads beside the rest.
      item_scores(sm, wg, wg, 0, s, wtid, mine);
      mbar_arrive(&sm.empty[s]);
      exchange_scores(sm, wg, wtid, mine, other);

      // P = exp(S scale + bias - LSE); dS = P (dP - delta) scale, split
      // into tf32 A fragments.
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        float sc[4], dp[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[e] = wg == 0 ? mine[4 * jj + e] : other[4 * jj + e];
          dp[e] = wg == 0 ? other[4 * jj + e] : mine[4 * jj + e];
        }
        const int2 m = *reinterpret_cast<const int2*>(km + 8 * jj + c);
        const float p0 = expf(sc[0] * scale + bias(m.x, qm0) - lse0);
        const float p1 = expf(sc[1] * scale + bias(m.y, qm0) - lse0);
        const float p2 = expf(sc[2] * scale + bias(m.x, qm1) - lse1);
        const float p3 = expf(sc[3] * scale + bias(m.y, qm1) - lse1);
        to_frag(p0 * (dp[0] - dl0) * scale, p1 * (dp[1] - dl0) * scale,
                p2 * (dp[2] - dl1) * scale, p3 * (dp[3] - dl1) * scale,
                shi[jj], slo[jj]);
      }

      // dQ += dS K (K^T), the warpgroup's chunks, a tile's partial
      // product added by the threads.
      fence_frags(shi);
      fence_frags(slo);
#pragma unroll
      for (int cc = 0; cc < NCH; ++cc) undef_f32(part[cc]);
      wgmma_fence();
      contract_wide(sm, 0, NCH * wg, part, shi, slo);
      wgmma_commit();
      wgmma_wait<0>();
      add_parts(dqacc, part);
      fence_frags(shi);
      fence_frags(slo);
    }

    mbar_arrive(sm.res_empty);
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc)
      store_chunk<P::D>(dq, qrow, NCH * wg + cc, r, c, dqacc[cc]);
  }
}

// The __global__ kernels: the two regimes run the same bodies under their
// own names, so the profiler tells them apart.
#define LDDL_DKV_KERNEL(name)                                               \
  template <int D>                                                          \
  __global__ void __launch_bounds__(BwdPlan<D, true>::NTHREADS, 1) name(    \
      const __grid_constant__ CUtensorMap map_q,                            \
      const __grid_constant__ CUtensorMap map_k,                            \
      const __grid_constant__ CUtensorMap map_v,                            \
      const __grid_constant__ CUtensorMap map_do,                           \
      const int* __restrict__ kmask, const int* __restrict__ qmask,         \
      const float* __restrict__ lse, const float* __restrict__ delta,       \
      float* __restrict__ dk, float* __restrict__ dv, int BH, int L, int H, \
      float scale) {                                                        \
    extern __shared__ uint8_t smem_raw[];                                   \
    if constexpr (D == 256)                                                 \
      dkv_body_wide(smem_raw, &map_q, &map_k, &map_v, &map_do, kmask,       \
                    qmask, lse, delta, dk, dv, BH, L, H, scale);            \
    else                                                                    \
      dkv_body<D>(smem_raw, &map_q, &map_k, &map_v, &map_do, kmask, qmask,  \
                  lse, delta, dk, dv, BH, L, H, scale);                     \
  }
#define LDDL_DQ_KERNEL(name)                                                \
  template <int D>                                                          \
  __global__ void __launch_bounds__(BwdPlan<D, false>::NTHREADS, 1) name(   \
      const __grid_constant__ CUtensorMap map_q,                            \
      const __grid_constant__ CUtensorMap map_k,                            \
      const __grid_constant__ CUtensorMap map_v,                            \
      const __grid_constant__ CUtensorMap map_do,                           \
      const int* __restrict__ kmask, const int* __restrict__ qmask,         \
      const float* __restrict__ lse, const float* __restrict__ delta,       \
      float* __restrict__ dq, int BH, int L, int H, float scale) {          \
    extern __shared__ uint8_t smem_raw[];                                   \
    if constexpr (D == 256)                                                 \
      dq_body_wide(smem_raw, &map_q, &map_k, &map_v, &map_do, kmask, qmask, \
                   lse, delta, dq, BH, L, H, scale);                        \
    else                                                                    \
      dq_body<D>(smem_raw, &map_q, &map_k, &map_v, &map_do, kmask, qmask,   \
                 lse, delta, dq, BH, L, H, scale);                          \
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
  using P = BwdPlan<D, DKV>;
  if (!shape_ok(BH, L, 128)) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, dout};
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 4 && err == cudaSuccess; ++i)
    err = make_map_f32(&maps[i], ptrs[i], (uint64_t)BH * L, D, P::TR);
  int grid = 0;
  if (err == cudaSuccess) err = persistent_grid<P>(kernel, BH, L, &grid);
  if (err != cudaSuccess) return (int)err;
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
  if (D == 256)
    return launch<256, false>(online_bwd_dq_f32_kernel<256>, q, k, v, dout,
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
  if (D == 256)
    return launch<256, true>(online_bwd_dkv_f32_kernel<256>, q, k, v, dout,
                             kmask, qmask, lse, delta, BH, L, H, scale, s,
                             dk, dv);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
