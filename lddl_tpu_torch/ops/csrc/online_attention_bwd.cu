// Attention backward for Hopper (sm_90a): the port of the three backward
// Pallas kernels in lddl_tpu/ops/flash_attention.py. Two kernel bodies, a
// dQ body and a dK/dV body, each instantiated as one __global__ kernel per
// regime of the reference, with a C entry point per kernel call:
//
//   online_bwd_dq_kernel   replaces _bwd_dq_kernel   (lddl_online_bwd_dq)
//   online_bwd_dkv_kernel  replaces _bwd_dkv_kernel  (lddl_online_bwd_dkv)
//   onekv_bwd_dkv_kernel   } together replace _onekv_bwd_kernel
//   onekv_bwd_dq_kernel    } (lddl_onekv_bwd launches both)
//
// The kernels are launched on their own as the reference makes two
// online pallas_calls; no atomics, so results do not depend on block
// scheduling and two launches are bit-identical. The forward kernels are
// in attention_fwd.cu.
//
// What they compute (identical to the TPU kernels, per (batch*head) row):
//   S  = Q K^T * scale + bias, bias = 0 where kmask > 0 && kmask == qmask,
//        else -1e9 (fp32, added to the scaled fp32 score; never -inf);
//   P  = exp(S - LSE), dP = dO V^T, dS = P (dP - delta) scale;
//   dq:  walk K/V tiles, dQ += dS K (dS rounded to bf16);
//   dkv: walk Q/dO tiles in the transposed layout, dV += P^T dO (P
//        rounded to bf16), dK += dS^T Q (dS rounded to bf16).
// The single-block TPU kernel computes P, dV, dP, dS, dQ and dK for a
// whole row at once. Given LSE and delta that is the same function: P and
// the bf16 roundings of P and dS are elementwise, so only the fp32
// summation order differs. The dK/dV and dQ kernels recompute S and dP
// (7 products against the TPU kernel's 5) instead of summing dQ with
// atomics.
// No tile is skipped: padded query rows (qmask 0) see every key
// disallowed and spread over all L_pad keys, as in the reference.
// Layout: q/k/v/dO/dQ/dK/dV [B*H, L_pad, D] bf16, masks int32 [B, L_pad],
// LSE and delta (rowsum(dO * O), computed outside) fp32 [B*H, L_pad].
// L_pad is a multiple of 128; D is 64, 128 or 256 (template; the wrapper
// zero-pads any other head dim up to one of them). The single-block
// kernels are built at D=64 and 128 only: the reference's single-block
// regime never takes a wider head.
//
// What bounds them on this card: at the BART path's shape (B=8, H=12,
// L_pad 1024, D=64) dQ does 38.7 GFLOP of bf16 products and dK/dV 51.5
// against 64-76 MB of operands (39 and 52 us at 989 TFLOP/s, 19 and 23 us
// at 3.35 TB/s); at bert_large's largest kernel bin (B=16, H=16, L_pad
// 512, D=64) the single-block pair does 60.1 GFLOP against 118 MB (61 and
// 35 us): all are bound by the tensor cores.
//
// Design (warp specialisation, hopper_tiles.cuh): a block of three
// warpgroups works on items of 128 rows of one (batch*head): 128 keys
// (dK/dV) or 128 queries (dQ). Warpgroups 0 and 1 are consumers with 64
// rows each; one thread of warpgroup 2, the producer, loads an item's own
// rows once by TMA and then streams the other side in 64-row tiles (Q and
// dO, or K and V, with the tile's mask, LSE and delta slices by bulk
// copy) through a ring of stages guarded by full/empty mbarriers. Tiles
// arrive in shared memory with the 128-byte swizzle, which wgmma reads
// directly: as a K-major operand for the score products and, through a
// second descriptor over the same bytes, as an MN-major B for the
// products that contract over the streamed rows. Each consumer warpgroup
// computes its 64 x 64 score tiles with wgmma m64n64k16 (both operands
// from shared memory) into registers, applies bias, exp and dS there, and
// feeds P or dS to the next product as the register A operand: no score
// tile passes through shared memory. Per tile, dQ issues two groups of
// products (S with dP, then dQ); dK/dV three (S^T, then dV with dP^T,
// then dK), which keeps fewer registers live than pairing S^T with dP^T.
// setmaxnreg moves registers from the producer (24) to the consumers
// (240), which hold S, dP and the fp32 accumulators (dK and dV: 32
// registers each at D=64, 64 at D=128). The epilogue writes the bf16
// result into the warpgroup's own (now dead) input rows in the swizzled
// layout and stores it by TMA.
//
// At D=256 (Plan below) the shared memory and the registers run out:
// - dK/dV of 64 key rows and all 256 columns would take 256 fp32
//   registers a thread, beside S^T and dP^T, where a consumer has 240. So
//   a dK/dV item is 64 keys, both consumer warpgroups compute the same
//   S^T and dP^T tiles over all of D, and each keeps half of D's columns
//   of dK and dV (64 + 64 registers, as at D=128). The score products are
//   done twice, 1.5x the tensor work of the undivided body; it needs no
//   atomics and no exchange through shared memory, and a two-pass walk
//   (dV, then dK) would recompute S^T and stream Q and dO twice. The two
//   warpgroups meet at a named barrier before staging their halves in the
//   item's K and V panels, which both read until their last tile.
// - A dQ item stays 128 queries (dQ of 64 rows: 128 registers a thread,
//   plus S and dP). Its resident Q and dO take 128 KB, so it has one item
//   buffer and one ring stage (64 KB of K and V): the tile loads are not
//   overlapped with the products.
// - The 64-key dK/dV item's K and V take 64 KB: one item buffer, two ring
//   stages of Q and dO (64 KB each).
//
// Every kernel runs a persistent grid of at most one block per SM; a
// block walks the items blockIdx.x, blockIdx.x + gridDim.x, ... At L_pad
// 256 an item streams only 4 tiles, and a block of its own per item left
// the loads of its own rows, the first tiles and the epilogue exposed.
// Up to D=128 items' own rows are double-buffered, so the producer loads
// the next item's rows and tiles while the consumers finish the current
// one; the ring runs on across items.

#include <math.h>

#include "hopper_tiles.cuh"

namespace {

using namespace lddl_hopper;

constexpr int NCONSUMER = 256;                 // two consumer warpgroups
constexpr int NTHREADS = NCONSUMER + 128;      // + the producer warpgroup
constexpr int ROWS = 128;                      // rows a work item owns
constexpr int STEP = 64;                       // rows of a streamed tile
constexpr int RING_PANEL = STEP * ROW_BYTES;   // 8 KB: one 64-row panel
constexpr int RES_PANEL = ROWS * ROW_BYTES;    // 16 KB: one 128-row panel
constexpr int SLICE = STEP * 4;                // a tile's int32/fp32 slice
constexpr int CONSUMER_REGS = 240;
constexpr int PRODUCER_REGS = 24;
constexpr float NEG_BIG = -1e9f;

static_assert(2 * CONSUMER_REGS * 128 + PRODUCER_REGS * 128 <= 65536,
              "the register file of one SM");

// How a body (DKV: the dK/dV body, else the dQ body) divides its work
// and its shared memory at head dim D.
template <int D, bool DKV>
struct Plan {
  static constexpr int DN = D / PANEL;
  // Both consumer warpgroups take the item's rows, each half of D's
  // columns of the accumulators (dK/dV at D=256); otherwise each takes 64
  // rows and all the columns.
  static constexpr bool SPLIT = DKV && D == 256;
  static constexpr int IROWS = SPLIT ? STEP : ROWS;  // rows of a work item
  // Item buffers: two (the next item's rows load while the consumers
  // finish the current one) up to D=128, one at D=256.
  static constexpr int RB = D == 256 ? 1 : 2;
  // Ring stages: three at D=64; two at D=128, where the two item buffers
  // take 128 KB; at D=256 two for dK/dV and one for dQ.
  static constexpr int PS = D == 64 ? 3 : (D == 128 || DKV) ? 2 : 1;
  static constexpr int RES_P = IROWS * ROW_BYTES;   // a resident panel
  static constexpr int RES = 2 * DN * RES_P;        // an item's two operands
  static constexpr int SLICES = DKV ? 3 : 1;        // row slices a stage
  // The item buffers, the ring's stages of two streamed STEP-row tiles
  // and their row slices, the barriers, and room to align the base to
  // 1024 bytes.
  static constexpr size_t SMEM = RB * RES +
                                 PS * (2 * DN * RING_PANEL + SLICES * SLICE) +
                                 (2 * PS + 2 * RB) * 8 + 1024;
  static_assert(SMEM <= 232448, "227 KB of shared memory");
};

__device__ __forceinline__ float bias(int km, int qm) {
  return (km > 0 && km == qm) ? 0.0f : NEG_BIG;
}

// The dK/dV mainloop: per work item (128 keys of one batch*head), walk
// the Q/dO tiles. The maps are the kernel's __grid_constant__ parameters.
template <int D>
__device__ __forceinline__ void dkv_body(
    uint8_t* smem_raw, const CUtensorMap* map_q, const CUtensorMap* map_k,
    const CUtensorMap* map_v, const CUtensorMap* map_do,
    const CUtensorMap* map_dk, const CUtensorMap* map_dv,
    const int* __restrict__ kmask, const int* __restrict__ qmask,
    const float* __restrict__ lse, const float* __restrict__ delta, int BH,
    int L, int H, float scale) {
  using P = Plan<D, true>;
  constexpr int DN = P::DN, PS = P::PS, RB = P::RB;
  constexpr int AN = P::SPLIT ? DN / 2 : DN;       // accumulator panels
  constexpr int RES = P::RES, RES_P = P::RES_P, IROWS = P::IROWS;
  uint8_t* res = align_1024(smem_raw);             // RB item buffers
  uint8_t* ring = res + RB * RES;                  // per stage: Q, then dO
  uint8_t* slices = ring + PS * 2 * DN * RING_PANEL;   // qmask, lse, delta
  uint64_t* full = reinterpret_cast<uint64_t*>(slices + PS * 3 * SLICE);
  uint64_t* empty = full + PS;
  uint64_t* res_full = empty + PS;
  uint64_t* res_empty = res_full + RB;

  const int nblk = L / IROWS, nitems = BH * nblk, ntiles = L / STEP;

  if (threadIdx.x == 0) {
    for (int s = 0; s < PS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCONSUMER);
    }
    for (int i = 0; i < RB; ++i) {
      mbar_init(&res_full[i], 1);
      mbar_init(&res_empty[i], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= NCONSUMER) {
    // Producer: per item, K and V once (into the item's buffer, once the
    // item RB back has stored its results from it), then the Q/dO ring.
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != NCONSUMER) return;
    int t = 0;
    for (int item = blockIdx.x, j = 0; item < nitems;
         item += gridDim.x, ++j) {
      const int bh = item / nblk, k0 = (item % nblk) * IROWS, b = bh / H;
      const int row0 = bh * L, rb = j % RB;
      uint8_t* sK = res + rb * RES;
      uint8_t* sV = sK + DN * RES_P;
      mbar_wait(&res_empty[rb], ((j / RB) & 1) ^ 1);
      mbar_arrive_expect_tx(&res_full[rb], RES);
      for (int p = 0; p < DN; ++p)
        for (int h = 0; h < IROWS / STEP; ++h) {
          tma_load_2d(sK + p * RES_P + h * RING_PANEL, map_k, p * PANEL,
                      row0 + k0 + h * STEP, &res_full[rb]);
          tma_load_2d(sV + p * RES_P + h * RING_PANEL, map_v, p * PANEL,
                      row0 + k0 + h * STEP, &res_full[rb]);
        }
      for (int i = 0; i < ntiles; ++i, ++t) {
        const int s = t % PS;
        mbar_wait(&empty[s], ((t / PS) & 1) ^ 1);
        uint8_t* st = ring + s * 2 * DN * RING_PANEL;
        uint8_t* sl = slices + s * 3 * SLICE;
        mbar_arrive_expect_tx(&full[s], 2 * DN * RING_PANEL + 3 * SLICE);
        for (int p = 0; p < DN; ++p) {
          tma_load_2d(st + p * RING_PANEL, map_q, p * PANEL,
                      row0 + i * STEP, &full[s]);
          tma_load_2d(st + (DN + p) * RING_PANEL, map_do, p * PANEL,
                      row0 + i * STEP, &full[s]);
        }
        bulk_load(sl, qmask + (size_t)b * L + i * STEP, SLICE, &full[s]);
        bulk_load(sl + SLICE, lse + (size_t)row0 + i * STEP, SLICE,
                  &full[s]);
        bulk_load(sl + 2 * SLICE, delta + (size_t)row0 + i * STEP, SLICE,
                  &full[s]);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns key rows [64 kr, 64 kr + 64) of an
  // item (kr = wg; kr = 0 under SPLIT, where the item is those 64 rows)
  // and the accumulators' panels [p0, p0 + AN) (all of them, or half
  // under SPLIT). Its thread holds accumulator rows r and r + 8 (keys)
  // and, for each 8-column chunk j, columns 8j + c and 8j + c + 1
  // (queries) of the score tiles.
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128;
  const int r = 16 * (wtid / 32) + (wtid % 32) / 4, c = 2 * (wtid % 4);
  const int kr = P::SPLIT ? 0 : wg, p0 = P::SPLIT ? wg * AN : 0;
  float dk[AN][32], dv[AN][32], st[32], dpt[32];
  uint32_t pt[4][4], dst[4][4];   // P^T and dS^T as bf16 A fragments
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    st[i] = 0.0f;
    dpt[i] = 0.0f;
  }
  int t = 0;
  for (int item = blockIdx.x, j = 0; item < nitems;
       item += gridDim.x, ++j) {
    const int bh = item / nblk, k0 = (item % nblk) * IROWS, b = bh / H;
    const int row0 = bh * L, rb = j % RB;
    uint8_t* sK = res + rb * RES;
    uint8_t* sV = sK + DN * RES_P;
    const int km0 = kmask[(size_t)b * L + k0 + STEP * kr + r];
    const int km1 = kmask[(size_t)b * L + k0 + STEP * kr + r + 8];
    const uint8_t* myK = sK + kr * RING_PANEL;   // the warpgroup's rows
    const uint8_t* myV = sV + kr * RING_PANEL;
#pragma unroll
    for (int i = 0; i < 32; ++i)
#pragma unroll
      for (int p = 0; p < AN; ++p) dk[p][i] = dv[p][i] = 0.0f;
    mbar_wait(&res_full[rb], (j / RB) & 1);

    for (int i = 0; i < ntiles; ++i, ++t) {
      const int s = t % PS;
      mbar_wait(&full[s], (t / PS) & 1);
      const uint8_t* sQ = ring + s * 2 * DN * RING_PANEL;
      const uint8_t* sdO = sQ + DN * RING_PANEL;
      const int* qm = reinterpret_cast<const int*>(slices + s * 3 * SLICE);
      const float* ql = reinterpret_cast<const float*>(qm + STEP);
      const float* qd = ql + STEP;

      // S^T = K Q^T (64 keys x 64 queries).
      fence_regs(st);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        wgmma_ss<0>(st, kmajor_desc(myK + (k / 4) * RES_P, k % 4),
                    kmajor_desc(sQ + (k / 4) * RING_PANEL, k % 4), k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);

      // P^T = exp(S^T scale + bias - LSE), kept in fp32 for dS^T.
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int2 m = *reinterpret_cast<const int2*>(qm + 8 * jj + c);
        const float2 l = *reinterpret_cast<const float2*>(ql + 8 * jj + c);
        st[4 * jj + 0] = expf(st[4 * jj + 0] * scale + bias(km0, m.x) - l.x);
        st[4 * jj + 1] = expf(st[4 * jj + 1] * scale + bias(km0, m.y) - l.y);
        st[4 * jj + 2] = expf(st[4 * jj + 2] * scale + bias(km1, m.x) - l.x);
        st[4 * jj + 3] = expf(st[4 * jj + 3] * scale + bias(km1, m.y) - l.y);
      }
      acc_to_a(st, pt);

      // dV += P^T dO (P^T from registers, dO as an MN-major B) and
      // dP^T = V dO^T, in one group.
      fence_regs(pt);
      fence_regs(dpt);
#pragma unroll
      for (int p = 0; p < AN; ++p) fence_regs(dv[p]);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < AN; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<1>(dv[p], pt[kk],
                      mnmajor_desc(sdO + (p0 + p) * RING_PANEL, kk));
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        wgmma_ss<0>(dpt, kmajor_desc(myV + (k / 4) * RES_P, k % 4),
                    kmajor_desc(sdO + (k / 4) * RING_PANEL, k % 4), k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dpt);
      fence_regs(pt);
#pragma unroll
      for (int p = 0; p < AN; ++p) fence_regs(dv[p]);

      // dS^T = P^T (dP^T - delta) scale, rounded to bf16 as the A operand.
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 d = *reinterpret_cast<const float2*>(qd + 8 * jj + c);
        st[4 * jj + 0] = st[4 * jj + 0] * (dpt[4 * jj + 0] - d.x) * scale;
        st[4 * jj + 1] = st[4 * jj + 1] * (dpt[4 * jj + 1] - d.y) * scale;
        st[4 * jj + 2] = st[4 * jj + 2] * (dpt[4 * jj + 2] - d.x) * scale;
        st[4 * jj + 3] = st[4 * jj + 3] * (dpt[4 * jj + 3] - d.y) * scale;
      }
      acc_to_a(st, dst);

      // dK += dS^T Q (Q as an MN-major B).
      fence_regs(dst);
#pragma unroll
      for (int p = 0; p < AN; ++p) fence_regs(dk[p]);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < AN; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<1>(dk[p], dst[kk],
                      mnmajor_desc(sQ + (p0 + p) * RING_PANEL, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dst);
#pragma unroll
      for (int p = 0; p < AN; ++p) fence_regs(dk[p]);
      mbar_arrive(&empty[s]);
    }

    // The warpgroup's K and V rows are dead (under SPLIT once the other
    // warpgroup, which reads all the item's panels, is past its last
    // tile): stage dK and dV there as bf16 in the swizzled layout; one
    // thread stores them by TMA and, once the store has read them, frees
    // the buffer for the item RB on.
    if (P::SPLIT) named_barrier(3, NCONSUMER);
#pragma unroll
    for (int p = 0; p < AN; ++p) {
      acc_to_panel(dk[p], sK + (p0 + p) * RES_P + kr * RING_PANEL, wtid);
      acc_to_panel(dv[p], sV + (p0 + p) * RES_P + kr * RING_PANEL, wtid);
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (wtid == 0) {
      for (int p = p0; p < p0 + AN; ++p) {
        tma_store_2d(map_dk, sK + p * RES_P + kr * RING_PANEL, p * PANEL,
                     row0 + k0 + kr * STEP);
        tma_store_2d(map_dv, sV + p * RES_P + kr * RING_PANEL, p * PANEL,
                     row0 + k0 + kr * STEP);
      }
      tma_store_commit_and_wait_read();
      mbar_arrive(&res_empty[rb]);
    }
  }
}

// The dQ mainloop: per work item (128 queries of one batch*head), walk
// the K/V tiles.
template <int D>
__device__ __forceinline__ void dq_body(
    uint8_t* smem_raw, const CUtensorMap* map_q, const CUtensorMap* map_k,
    const CUtensorMap* map_v, const CUtensorMap* map_do,
    const CUtensorMap* map_dq, const int* __restrict__ kmask,
    const int* __restrict__ qmask, const float* __restrict__ lse,
    const float* __restrict__ delta, int BH, int L, int H, float scale) {
  using P = Plan<D, false>;
  constexpr int DN = P::DN, PS = P::PS, RB = P::RB, RES = P::RES;
  static_assert(P::IROWS == ROWS && P::RES_P == RES_PANEL, "128-row items");
  uint8_t* res = align_1024(smem_raw);             // RB item buffers
  uint8_t* ring = res + RB * RES;                  // per stage: K, then V
  uint8_t* slices = ring + PS * 2 * DN * RING_PANEL;   // kmask
  uint64_t* full = reinterpret_cast<uint64_t*>(slices + PS * SLICE);
  uint64_t* empty = full + PS;
  uint64_t* res_full = empty + PS;
  uint64_t* res_empty = res_full + RB;

  const int nblk = L / ROWS, nitems = BH * nblk, ntiles = L / STEP;

  if (threadIdx.x == 0) {
    for (int s = 0; s < PS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCONSUMER);
    }
    for (int i = 0; i < RB; ++i) {
      mbar_init(&res_full[i], 1);
      mbar_init(&res_empty[i], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= NCONSUMER) {
    // Producer: per item, Q and dO once, then the K/V ring.
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != NCONSUMER) return;
    int t = 0;
    for (int item = blockIdx.x, j = 0; item < nitems;
         item += gridDim.x, ++j) {
      const int bh = item / nblk, q0 = (item % nblk) * ROWS, b = bh / H;
      const int row0 = bh * L, rb = j % RB;
      uint8_t* sQ = res + rb * RES;
      uint8_t* sdO = sQ + DN * RES_PANEL;
      mbar_wait(&res_empty[rb], ((j / RB) & 1) ^ 1);
      mbar_arrive_expect_tx(&res_full[rb], RES);
      for (int p = 0; p < DN; ++p)
        for (int h = 0; h < ROWS / STEP; ++h) {
          tma_load_2d(sQ + p * RES_PANEL + h * RING_PANEL, map_q, p * PANEL,
                      row0 + q0 + h * STEP, &res_full[rb]);
          tma_load_2d(sdO + p * RES_PANEL + h * RING_PANEL, map_do,
                      p * PANEL, row0 + q0 + h * STEP, &res_full[rb]);
        }
      for (int i = 0; i < ntiles; ++i, ++t) {
        const int s = t % PS;
        mbar_wait(&empty[s], ((t / PS) & 1) ^ 1);
        uint8_t* st = ring + s * 2 * DN * RING_PANEL;
        mbar_arrive_expect_tx(&full[s], 2 * DN * RING_PANEL + SLICE);
        for (int p = 0; p < DN; ++p) {
          tma_load_2d(st + p * RING_PANEL, map_k, p * PANEL,
                      row0 + i * STEP, &full[s]);
          tma_load_2d(st + (DN + p) * RING_PANEL, map_v, p * PANEL,
                      row0 + i * STEP, &full[s]);
        }
        bulk_load(slices + s * SLICE, kmask + (size_t)b * L + i * STEP,
                  SLICE, &full[s]);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) of an
  // item; its thread holds rows r and r + 8 (queries) and columns
  // 8j + c, 8j + c + 1 (keys) of each score tile.
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128;
  const int r = 16 * (wtid / 32) + (wtid % 32) / 4, c = 2 * (wtid % 4);
  float dq[DN][32], sc[32], dp[32];
  uint32_t a[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = 0.0f;
    dp[i] = 0.0f;
  }
  int t = 0;
  for (int item = blockIdx.x, j = 0; item < nitems;
       item += gridDim.x, ++j) {
    const int bh = item / nblk, q0 = (item % nblk) * ROWS, b = bh / H;
    const int row0 = bh * L, rb = j % RB;
    uint8_t* sQ = res + rb * RES;
    uint8_t* sdO = sQ + DN * RES_PANEL;
    const int qrow = q0 + STEP * wg + r;
    const int qm0 = qmask[(size_t)b * L + qrow];
    const int qm1 = qmask[(size_t)b * L + qrow + 8];
    const float lse0 = lse[(size_t)row0 + qrow];
    const float lse1 = lse[(size_t)row0 + qrow + 8];
    const float dl0 = delta[(size_t)row0 + qrow];
    const float dl1 = delta[(size_t)row0 + qrow + 8];
    const uint8_t* myQ = sQ + wg * RING_PANEL;   // the warpgroup's rows
    const uint8_t* mydO = sdO + wg * RING_PANEL;
#pragma unroll
    for (int i = 0; i < 32; ++i)
#pragma unroll
      for (int p = 0; p < DN; ++p) dq[p][i] = 0.0f;
    mbar_wait(&res_full[rb], (j / RB) & 1);

    for (int i = 0; i < ntiles; ++i, ++t) {
      const int s = t % PS;
      mbar_wait(&full[s], (t / PS) & 1);
      const uint8_t* sK = ring + s * 2 * DN * RING_PANEL;
      const uint8_t* sV = sK + DN * RING_PANEL;
      const int* km = reinterpret_cast<const int*>(slices + s * SLICE);

      // S = Q K^T and dP = dO V^T (64 queries x 64 keys), in one group.
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        wgmma_ss<0>(sc, kmajor_desc(myQ + (k / 4) * RES_PANEL, k % 4),
                    kmajor_desc(sK + (k / 4) * RING_PANEL, k % 4), k > 0);
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        wgmma_ss<0>(dp, kmajor_desc(mydO + (k / 4) * RES_PANEL, k % 4),
                    kmajor_desc(sV + (k / 4) * RING_PANEL, k % 4), k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // P = exp(S scale + bias - LSE); dS = P (dP - delta) scale.
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int2 m = *reinterpret_cast<const int2*>(km + 8 * jj + c);
        float p0 = expf(sc[4 * jj + 0] * scale + bias(m.x, qm0) - lse0);
        float p1 = expf(sc[4 * jj + 1] * scale + bias(m.y, qm0) - lse0);
        float p2 = expf(sc[4 * jj + 2] * scale + bias(m.x, qm1) - lse1);
        float p3 = expf(sc[4 * jj + 3] * scale + bias(m.y, qm1) - lse1);
        sc[4 * jj + 0] = p0 * (dp[4 * jj + 0] - dl0) * scale;
        sc[4 * jj + 1] = p1 * (dp[4 * jj + 1] - dl0) * scale;
        sc[4 * jj + 2] = p2 * (dp[4 * jj + 2] - dl1) * scale;
        sc[4 * jj + 3] = p3 * (dp[4 * jj + 3] - dl1) * scale;
      }
      acc_to_a(sc, a);

      // dQ += dS K (dS from registers, K as an MN-major B).
      fence_regs(a);
#pragma unroll
      for (int p = 0; p < DN; ++p) fence_regs(dq[p]);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < DN; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<1>(dq[p], a[kk], mnmajor_desc(sK + p * RING_PANEL, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(a);
#pragma unroll
      for (int p = 0; p < DN; ++p) fence_regs(dq[p]);
      mbar_arrive(&empty[s]);
    }

    // The warpgroup's Q rows are dead: stage dQ there, store it by TMA.
#pragma unroll
    for (int p = 0; p < DN; ++p)
      acc_to_panel(dq[p], sQ + p * RES_PANEL + wg * RING_PANEL, wtid);
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (wtid == 0) {
      for (int p = 0; p < DN; ++p)
        tma_store_2d(map_dq, sQ + p * RES_PANEL + wg * RING_PANEL,
                     p * PANEL, row0 + q0 + wg * STEP);
      tma_store_commit_and_wait_read();
      mbar_arrive(&res_empty[rb]);
    }
  }
}

// The __global__ kernels: the two regimes run the same bodies under their
// own names, so the profiler tells them apart.
#define LDDL_DKV_KERNEL(name)                                               \
  template <int D>                                                          \
  __global__ void __launch_bounds__(NTHREADS, 1) name(                      \
      const __grid_constant__ CUtensorMap map_q,                            \
      const __grid_constant__ CUtensorMap map_k,                            \
      const __grid_constant__ CUtensorMap map_v,                            \
      const __grid_constant__ CUtensorMap map_do,                           \
      const __grid_constant__ CUtensorMap map_dk,                           \
      const __grid_constant__ CUtensorMap map_dv,                           \
      const int* __restrict__ kmask, const int* __restrict__ qmask,         \
      const float* __restrict__ lse, const float* __restrict__ delta,       \
      int BH, int L, int H, float scale) {                                  \
    extern __shared__ uint8_t smem_raw[];                                   \
    dkv_body<D>(smem_raw, &map_q, &map_k, &map_v, &map_do, &map_dk,         \
                &map_dv, kmask, qmask, lse, delta, BH, L, H, scale);        \
  }
#define LDDL_DQ_KERNEL(name)                                                \
  template <int D>                                                          \
  __global__ void __launch_bounds__(NTHREADS, 1) name(                      \
      const __grid_constant__ CUtensorMap map_q,                            \
      const __grid_constant__ CUtensorMap map_k,                            \
      const __grid_constant__ CUtensorMap map_v,                            \
      const __grid_constant__ CUtensorMap map_do,                           \
      const __grid_constant__ CUtensorMap map_dq,                           \
      const int* __restrict__ kmask, const int* __restrict__ qmask,         \
      const float* __restrict__ lse, const float* __restrict__ delta,       \
      int BH, int L, int H, float scale) {                                  \
    extern __shared__ uint8_t smem_raw[];                                   \
    dq_body<D>(smem_raw, &map_q, &map_k, &map_v, &map_do, &map_dq, kmask,   \
               qmask, lse, delta, BH, L, H, scale);                         \
  }

LDDL_DKV_KERNEL(online_bwd_dkv_kernel)
LDDL_DQ_KERNEL(online_bwd_dq_kernel)
LDDL_DKV_KERNEL(onekv_bwd_dkv_kernel)
LDDL_DQ_KERNEL(onekv_bwd_dq_kernel)

#undef LDDL_DKV_KERNEL
#undef LDDL_DQ_KERNEL

// Blocks of a launch over BH * L / rows work items: at most one per SM.
inline cudaError_t grid_size(int BH, int L, int rows, int* grid) {
  *grid = BH * (L / rows);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && sms < *grid) *grid = sms;
  return err;
}

template <int D, typename Kernel>
int launch_dq(Kernel kernel, const void* q, const void* k, const void* v,
              const void* km, const void* qm, const void* dout,
              const void* lse, const void* delta, void* dq, int BH, int L,
              int H, float scale, cudaStream_t stream) {
  if (!shape_ok(BH, L, ROWS)) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[5];
  const void* ptrs[5] = {q, k, v, dout, dq};
  cudaError_t err = make_maps(maps, ptrs, 5, BH, L, D);
  int grid = 0;
  if (err == cudaSuccess)
    err = grid_size(BH, L, Plan<D, false>::IROWS, &grid);
  const size_t smem = Plan<D, false>::SMEM;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NTHREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], (const int*)km,
      (const int*)qm, (const float*)lse, (const float*)delta, BH, L, H,
      scale);
  return (int)cudaGetLastError();
}

template <int D, typename Kernel>
int launch_dkv(Kernel kernel, const void* q, const void* k, const void* v,
               const void* km, const void* qm, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int BH, int L, int H, float scale, cudaStream_t stream) {
  if (!shape_ok(BH, L, ROWS)) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[6];
  const void* ptrs[6] = {q, k, v, dout, dk, dv};
  cudaError_t err = make_maps(maps, ptrs, 6, BH, L, D);
  int grid = 0;
  if (err == cudaSuccess)
    err = grid_size(BH, L, Plan<D, true>::IROWS, &grid);
  const size_t smem = Plan<D, true>::SMEM;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NTHREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], (const int*)km,
      (const int*)qm, (const float*)lse, (const float*)delta, BH, L, H,
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
  const int err = launch_dkv<D>(onekv_bwd_dkv_kernel<D>, q, k, v, km, qm,
                                dout, lse, delta, dk, dv, BH, L, H, scale,
                                stream);
  if (err != 0) return err;
  return launch_dq<D>(onekv_bwd_dq_kernel<D>, q, k, v, km, qm, dout, lse,
                      delta, dq, BH, L, H, scale, stream);
}

}  // namespace

// Plain C interface (loaded with ctypes). Each returns the cudaError_t of
// its launches: 0 on success. Inputs are checked by the Python wrapper.
extern "C" {

int lddl_online_bwd_dq(const void* q, const void* k, const void* v,
                       const void* kmask, const void* qmask,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, int BH, int L, int H, int D, float scale,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dq<64>(online_bwd_dq_kernel<64>, q, k, v, kmask, qmask,
                         dout, lse, delta, dq, BH, L, H, scale, s);
  if (D == 128)
    return launch_dq<128>(online_bwd_dq_kernel<128>, q, k, v, kmask, qmask,
                          dout, lse, delta, dq, BH, L, H, scale, s);
  if (D == 256)
    return launch_dq<256>(online_bwd_dq_kernel<256>, q, k, v, kmask, qmask,
                          dout, lse, delta, dq, BH, L, H, scale, s);
  return (int)cudaErrorInvalidValue;
}

int lddl_online_bwd_dkv(const void* q, const void* k, const void* v,
                        const void* kmask, const void* qmask,
                        const void* dout, const void* lse,
                        const void* delta, void* dk, void* dv, int BH, int L,
                        int H, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dkv<64>(online_bwd_dkv_kernel<64>, q, k, v, kmask, qmask,
                          dout, lse, delta, dk, dv, BH, L, H, scale, s);
  if (D == 128)
    return launch_dkv<128>(online_bwd_dkv_kernel<128>, q, k, v, kmask,
                           qmask, dout, lse, delta, dk, dv, BH, L, H, scale,
                           s);
  if (D == 256)
    return launch_dkv<256>(online_bwd_dkv_kernel<256>, q, k, v, kmask,
                           qmask, dout, lse, delta, dk, dv, BH, L, H, scale,
                           s);
  return (int)cudaErrorInvalidValue;
}

int lddl_onekv_bwd(const void* q, const void* k, const void* v,
                   const void* kmask, const void* qmask, const void* dout,
                   const void* lse, const void* delta, void* dq, void* dk,
                   void* dv, int BH, int L, int H, int D, float scale,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_onekv<64>(q, k, v, kmask, qmask, dout, lse, delta, dq, dk,
                            dv, BH, L, H, scale, s);
  if (D == 128)
    return launch_onekv<128>(q, k, v, kmask, qmask, dout, lse, delta, dq,
                             dk, dv, BH, L, H, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
