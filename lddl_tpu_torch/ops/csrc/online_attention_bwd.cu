// Long-sequence attention backward for Hopper (sm_90a): the port of the
// two online-softmax backward Pallas kernels in
// lddl_tpu/ops/flash_attention.py, one __global__ kernel and one C entry
// point each, launched on their own as the reference makes two
// pallas_calls (no atomics: results do not depend on block scheduling):
//
//   online_bwd_dq_kernel   replaces _bwd_dq_kernel   (lddl_online_bwd_dq)
//   online_bwd_dkv_kernel  replaces _bwd_dkv_kernel  (lddl_online_bwd_dkv)
//
// What they compute (identical to the TPU kernels, per (batch*head) row):
//   S  = Q K^T * scale + bias, bias = 0 where kmask > 0 && kmask == qmask,
//        else -1e9 (fp32, added to the scaled fp32 score; never -inf);
//   P  = exp(S - LSE), dP = dO V^T, dS = P (dP - delta) scale;
//   dq:  walk K/V tiles, dQ += dS K (dS rounded to bf16);
//   dkv: walk Q/dO tiles in the transposed layout, dV += P^T dO (P
//        rounded to bf16), dK += dS^T Q (dS rounded to bf16).
// No tile is skipped: padded query rows (qmask 0) see every key
// disallowed and spread over all L_pad keys, as in the reference.
// Layout: q/k/v/dO/dQ/dK/dV [B*H, L_pad, D] bf16, masks int32 [B, L_pad],
// LSE and delta (rowsum(dO * O), computed outside) fp32 [B*H, L_pad].
// L_pad is a multiple of 128; D is 64 or 128 (template).
//
// What bounds them on this card: at the BART path's shape (B=8, H=12,
// L_pad 1024, D=64) dQ does 38.7 GFLOP of bf16 products and dK/dV 51.5
// against 64-76 MB of operands (39 and 52 us at 989 TFLOP/s, 19 and 23 us
// at 3.35 TB/s): both are bound by the tensor cores.
//
// Design (warp specialisation, hopper_tiles.cuh): a block of three
// warpgroups owns 128 rows of one (batch*head): 128 keys (dK/dV) or 128
// queries (dQ). Warpgroups 0 and 1 are consumers with 64 rows each; one
// thread of warpgroup 2, the producer, loads the block's own rows once by
// TMA and then streams the other side in 64-row tiles (Q and dO, or K and
// V, with the tile's mask, LSE and delta slices by bulk copy) through a
// ring of NS stages guarded by full/empty mbarriers. Tiles arrive in
// shared memory with the 128-byte swizzle, which wgmma reads directly:
// as a K-major operand for the score products and, through a second
// descriptor over the same bytes, as an MN-major B for the products that
// contract over the streamed rows. Each consumer warpgroup computes its
// 64 x 64 score tiles with wgmma m64n64k16 (both operands from shared
// memory) into registers, applies bias, exp and dS there, and feeds P or
// dS to the next product as the register A operand: no score tile passes
// through shared memory. Per tile, dQ issues two groups of products
// (S with dP, then dQ); dK/dV three (S^T, then dV with dP^T, then dK),
// which keeps fewer registers live than pairing S^T with dP^T. setmaxnreg moves registers
// from the producer (24) to the consumers (240), which hold S, dP and the
// fp32 accumulators (dK and dV: 32 registers each at D=64, 64 at D=128).
// The epilogue writes the bf16 result into the warpgroup's own (now dead)
// input rows in the swizzled layout and stores it by TMA.

#include <math.h>

#include "hopper_tiles.cuh"

namespace {

using namespace lddl_hopper;

constexpr int NS = 3;                          // ring stages
constexpr int NCONSUMER = 256;                 // two consumer warpgroups
constexpr int NTHREADS = NCONSUMER + 128;      // + the producer warpgroup
constexpr int ROWS = 128;                      // rows a block owns
constexpr int STEP = 64;                       // rows of a streamed tile
constexpr int RING_PANEL = STEP * ROW_BYTES;   // 8 KB: one 64-row panel
constexpr int RES_PANEL = ROWS * ROW_BYTES;    // 16 KB: one 128-row panel
constexpr int SLICE = STEP * 4;                // a tile's int32/fp32 slice
constexpr int CONSUMER_REGS = 240;
constexpr int PRODUCER_REGS = 24;
constexpr float NEG_BIG = -1e9f;

static_assert(2 * CONSUMER_REGS * 128 + PRODUCER_REGS * 128 <= 65536,
              "the register file of one SM");

// Shared memory: two resident operands of ROWS rows, NS stages of two
// streamed STEP-row tiles, NS stages of `slices` row slices, the
// barriers, and room to align the base to 1024 bytes.
template <int D>
constexpr size_t smem_bytes(int slices) {
  return 2 * (D / PANEL) * RES_PANEL + NS * 2 * (D / PANEL) * RING_PANEL +
         NS * slices * SLICE + (2 * NS + 1) * 8 + 1024;
}

static_assert(smem_bytes<128>(3) <= 232448, "227 KB of shared memory");

__device__ __forceinline__ float bias(int km, int qm) {
  return (km > 0 && km == qm) ? 0.0f : NEG_BIG;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
online_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do,
                      const __grid_constant__ CUtensorMap map_dk,
                      const __grid_constant__ CUtensorMap map_dv,
                      const int* __restrict__ kmask,
                      const int* __restrict__ qmask,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, int L, int H,
                      float scale) {
  constexpr int DN = D / PANEL;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align_1024(smem_raw);        // DN panels of ROWS rows
  uint8_t* sV = sK + DN * RES_PANEL;
  uint8_t* ring = sV + DN * RES_PANEL;       // per stage: Q, then dO
  uint8_t* slices = ring + NS * 2 * DN * RING_PANEL;   // qmask, lse, delta
  uint64_t* full = reinterpret_cast<uint64_t*>(slices + NS * 3 * SLICE);
  uint64_t* empty = full + NS;
  uint64_t* kv_full = empty + NS;

  const int k0 = blockIdx.x * ROWS, bh = blockIdx.y, b = bh / H;
  const int row0 = bh * L;                   // this row's first 2-D row
  const int ntiles = L / STEP;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCONSUMER);
    }
    mbar_init(kv_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= NCONSUMER) {
    // Producer: K and V of the block once, then the Q/dO ring.
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != NCONSUMER) return;
    mbar_arrive_expect_tx(kv_full, 2 * DN * RES_PANEL);
    for (int p = 0; p < DN; ++p)
      for (int h = 0; h < ROWS / STEP; ++h) {
        tma_load_2d(sK + p * RES_PANEL + h * RING_PANEL, &map_k, p * PANEL,
                    row0 + k0 + h * STEP, kv_full);
        tma_load_2d(sV + p * RES_PANEL + h * RING_PANEL, &map_v, p * PANEL,
                    row0 + k0 + h * STEP, kv_full);
      }
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % NS;
      mbar_wait(&empty[s], ((t / NS) & 1) ^ 1);
      uint8_t* st = ring + s * 2 * DN * RING_PANEL;
      uint8_t* sl = slices + s * 3 * SLICE;
      mbar_arrive_expect_tx(&full[s], 2 * DN * RING_PANEL + 3 * SLICE);
      for (int p = 0; p < DN; ++p) {
        tma_load_2d(st + p * RING_PANEL, &map_q, p * PANEL, row0 + t * STEP,
                    &full[s]);
        tma_load_2d(st + (DN + p) * RING_PANEL, &map_do, p * PANEL,
                    row0 + t * STEP, &full[s]);
      }
      bulk_load(sl, qmask + (size_t)b * L + t * STEP, SLICE, &full[s]);
      bulk_load(sl + SLICE, lse + (size_t)row0 + t * STEP, SLICE, &full[s]);
      bulk_load(sl + 2 * SLICE, delta + (size_t)row0 + t * STEP, SLICE,
                &full[s]);
    }
    return;
  }

  // Consumers: warpgroup wg owns key rows [64 wg, 64 wg + 64) of the
  // block. Its thread holds accumulator rows r and r + 8 (keys) and, for
  // each 8-column chunk j, columns 8j + c and 8j + c + 1 (queries).
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128;
  const int r = 16 * (wtid / 32) + (wtid % 32) / 4, c = 2 * (wtid % 4);
  const int km0 = kmask[(size_t)b * L + k0 + STEP * wg + r];
  const int km1 = kmask[(size_t)b * L + k0 + STEP * wg + r + 8];
  const uint8_t* myK = sK + wg * RING_PANEL;   // the warpgroup's 64 rows
  const uint8_t* myV = sV + wg * RING_PANEL;

  float dk[DN][32], dv[DN][32], st[32], dpt[32];
  uint32_t pt[4][4], dst[4][4];   // P^T and dS^T as bf16 A fragments
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    st[i] = 0.0f;
    dpt[i] = 0.0f;
#pragma unroll
    for (int p = 0; p < DN; ++p) dk[p][i] = dv[p][i] = 0.0f;
  }
  mbar_wait(kv_full, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % NS;
    mbar_wait(&full[s], (t / NS) & 1);
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
      wgmma_ss<0>(st, kmajor_desc(myK + (k / 4) * RES_PANEL, k % 4),
                  kmajor_desc(sQ + (k / 4) * RING_PANEL, k % 4), k > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);

    // P^T = exp(S^T scale + bias - LSE), kept in fp32 for dS^T.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int2 m = *reinterpret_cast<const int2*>(qm + 8 * j + c);
      const float2 l = *reinterpret_cast<const float2*>(ql + 8 * j + c);
      st[4 * j + 0] = expf(st[4 * j + 0] * scale + bias(km0, m.x) - l.x);
      st[4 * j + 1] = expf(st[4 * j + 1] * scale + bias(km0, m.y) - l.y);
      st[4 * j + 2] = expf(st[4 * j + 2] * scale + bias(km1, m.x) - l.x);
      st[4 * j + 3] = expf(st[4 * j + 3] * scale + bias(km1, m.y) - l.y);
    }
    acc_to_a(st, pt);

    // dV += P^T dO (P^T from registers, dO as an MN-major B) and
    // dP^T = V dO^T, in one group.
    fence_regs(pt);
    fence_regs(dpt);
#pragma unroll
    for (int p = 0; p < DN; ++p) fence_regs(dv[p]);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < DN; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(dv[p], pt[kk], mnmajor_desc(sdO + p * RING_PANEL, kk));
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      wgmma_ss<0>(dpt, kmajor_desc(myV + (k / 4) * RES_PANEL, k % 4),
                  kmajor_desc(sdO + (k / 4) * RING_PANEL, k % 4), k > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dpt);
    fence_regs(pt);
#pragma unroll
    for (int p = 0; p < DN; ++p) fence_regs(dv[p]);

    // dS^T = P^T (dP^T - delta) scale, rounded to bf16 as the A operand.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(qd + 8 * j + c);
      st[4 * j + 0] = st[4 * j + 0] * (dpt[4 * j + 0] - d.x) * scale;
      st[4 * j + 1] = st[4 * j + 1] * (dpt[4 * j + 1] - d.y) * scale;
      st[4 * j + 2] = st[4 * j + 2] * (dpt[4 * j + 2] - d.x) * scale;
      st[4 * j + 3] = st[4 * j + 3] * (dpt[4 * j + 3] - d.y) * scale;
    }
    acc_to_a(st, dst);

    // dK += dS^T Q (Q as an MN-major B).
    fence_regs(dst);
#pragma unroll
    for (int p = 0; p < DN; ++p) fence_regs(dk[p]);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < DN; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(dk[p], dst[kk], mnmajor_desc(sQ + p * RING_PANEL, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dst);
#pragma unroll
    for (int p = 0; p < DN; ++p) fence_regs(dk[p]);
    mbar_arrive(&empty[s]);
  }

  // The warpgroup's K and V rows are dead: stage dK and dV there as bf16
  // in the swizzled layout, then one thread stores them by TMA.
#pragma unroll
  for (int p = 0; p < DN; ++p) {
    acc_to_panel(dk[p], sK + p * RES_PANEL + wg * RING_PANEL, wtid);
    acc_to_panel(dv[p], sV + p * RES_PANEL + wg * RING_PANEL, wtid);
  }
  fence_proxy_async();
  named_barrier(1 + wg, 128);
  if (wtid == 0) {
    for (int p = 0; p < DN; ++p) {
      tma_store_2d(&map_dk, sK + p * RES_PANEL + wg * RING_PANEL, p * PANEL,
                   row0 + k0 + wg * STEP);
      tma_store_2d(&map_dv, sV + p * RES_PANEL + wg * RING_PANEL, p * PANEL,
                   row0 + k0 + wg * STEP);
    }
    tma_store_commit_and_wait();
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
online_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do,
                     const __grid_constant__ CUtensorMap map_dq,
                     const int* __restrict__ kmask,
                     const int* __restrict__ qmask,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, int L, int H,
                     float scale) {
  constexpr int DN = D / PANEL;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align_1024(smem_raw);        // DN panels of ROWS rows
  uint8_t* sdO = sQ + DN * RES_PANEL;
  uint8_t* ring = sdO + DN * RES_PANEL;      // per stage: K, then V
  uint8_t* slices = ring + NS * 2 * DN * RING_PANEL;   // kmask
  uint64_t* full = reinterpret_cast<uint64_t*>(slices + NS * SLICE);
  uint64_t* empty = full + NS;
  uint64_t* qdo_full = empty + NS;

  const int q0 = blockIdx.x * ROWS, bh = blockIdx.y, b = bh / H;
  const int row0 = bh * L;
  const int ntiles = L / STEP;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCONSUMER);
    }
    mbar_init(qdo_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= NCONSUMER) {
    // Producer: Q and dO of the block once, then the K/V ring.
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != NCONSUMER) return;
    mbar_arrive_expect_tx(qdo_full, 2 * DN * RES_PANEL);
    for (int p = 0; p < DN; ++p)
      for (int h = 0; h < ROWS / STEP; ++h) {
        tma_load_2d(sQ + p * RES_PANEL + h * RING_PANEL, &map_q, p * PANEL,
                    row0 + q0 + h * STEP, qdo_full);
        tma_load_2d(sdO + p * RES_PANEL + h * RING_PANEL, &map_do,
                    p * PANEL, row0 + q0 + h * STEP, qdo_full);
      }
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % NS;
      mbar_wait(&empty[s], ((t / NS) & 1) ^ 1);
      uint8_t* st = ring + s * 2 * DN * RING_PANEL;
      mbar_arrive_expect_tx(&full[s], 2 * DN * RING_PANEL + SLICE);
      for (int p = 0; p < DN; ++p) {
        tma_load_2d(st + p * RING_PANEL, &map_k, p * PANEL, row0 + t * STEP,
                    &full[s]);
        tma_load_2d(st + (DN + p) * RING_PANEL, &map_v, p * PANEL,
                    row0 + t * STEP, &full[s]);
      }
      bulk_load(slices + s * SLICE, kmask + (size_t)b * L + t * STEP, SLICE,
                &full[s]);
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) of the
  // block; its thread holds rows r and r + 8 (queries) and columns
  // 8j + c, 8j + c + 1 (keys) of each score tile.
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128;
  const int r = 16 * (wtid / 32) + (wtid % 32) / 4, c = 2 * (wtid % 4);
  const int qrow = q0 + STEP * wg + r;
  const int qm0 = qmask[(size_t)b * L + qrow];
  const int qm1 = qmask[(size_t)b * L + qrow + 8];
  const float lse0 = lse[(size_t)row0 + qrow];
  const float lse1 = lse[(size_t)row0 + qrow + 8];
  const float dl0 = delta[(size_t)row0 + qrow];
  const float dl1 = delta[(size_t)row0 + qrow + 8];
  const uint8_t* myQ = sQ + wg * RING_PANEL;   // the warpgroup's 64 rows
  const uint8_t* mydO = sdO + wg * RING_PANEL;

  float dq[DN][32], sc[32], dp[32];
  uint32_t a[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = 0.0f;
    dp[i] = 0.0f;
#pragma unroll
    for (int p = 0; p < DN; ++p) dq[p][i] = 0.0f;
  }
  mbar_wait(qdo_full, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % NS;
    mbar_wait(&full[s], (t / NS) & 1);
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
    for (int j = 0; j < 8; ++j) {
      const int2 m = *reinterpret_cast<const int2*>(km + 8 * j + c);
      float p0 = expf(sc[4 * j + 0] * scale + bias(m.x, qm0) - lse0);
      float p1 = expf(sc[4 * j + 1] * scale + bias(m.y, qm0) - lse0);
      float p2 = expf(sc[4 * j + 2] * scale + bias(m.x, qm1) - lse1);
      float p3 = expf(sc[4 * j + 3] * scale + bias(m.y, qm1) - lse1);
      sc[4 * j + 0] = p0 * (dp[4 * j + 0] - dl0) * scale;
      sc[4 * j + 1] = p1 * (dp[4 * j + 1] - dl0) * scale;
      sc[4 * j + 2] = p2 * (dp[4 * j + 2] - dl1) * scale;
      sc[4 * j + 3] = p3 * (dp[4 * j + 3] - dl1) * scale;
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
      tma_store_2d(&map_dq, sQ + p * RES_PANEL + wg * RING_PANEL, p * PANEL,
                   row0 + q0 + wg * STEP);
    tma_store_commit_and_wait();
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* km,
              const void* qm, const void* dout, const void* lse,
              const void* delta, void* dq, int BH, int L, int H, float scale,
              cudaStream_t stream) {
  if (!shape_ok(BH, L, ROWS)) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[5];
  const void* ptrs[5] = {q, k, v, dout, dq};
  cudaError_t err = make_maps(maps, ptrs, 5, BH, L, D);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes<D>(1);
  err = cudaFuncSetAttribute(online_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  online_bwd_dq_kernel<D><<<dim3(L / ROWS, BH), NTHREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], (const int*)km,
      (const int*)qm, (const float*)lse, (const float*)delta, L, H, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* km,
               const void* qm, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int BH, int L, int H,
               float scale, cudaStream_t stream) {
  if (!shape_ok(BH, L, ROWS)) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[6];
  const void* ptrs[6] = {q, k, v, dout, dk, dv};
  cudaError_t err = make_maps(maps, ptrs, 6, BH, L, D);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes<D>(3);
  err = cudaFuncSetAttribute(online_bwd_dkv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  online_bwd_dkv_kernel<D><<<dim3(L / ROWS, BH), NTHREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], (const int*)km,
      (const int*)qm, (const float*)lse, (const float*)delta, L, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Each returns the cudaError_t of
// its launch: 0 on success. Inputs are checked by the Python wrapper.
extern "C" {

int lddl_online_bwd_dq(const void* q, const void* k, const void* v,
                       const void* kmask, const void* qmask,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, int BH, int L, int H, int D, float scale,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dq<64>(q, k, v, kmask, qmask, dout, lse, delta, dq, BH, L,
                         H, scale, s);
  if (D == 128)
    return launch_dq<128>(q, k, v, kmask, qmask, dout, lse, delta, dq, BH,
                          L, H, scale, s);
  return (int)cudaErrorInvalidValue;
}

int lddl_online_bwd_dkv(const void* q, const void* k, const void* v,
                        const void* kmask, const void* qmask,
                        const void* dout, const void* lse,
                        const void* delta, void* dk, void* dv, int BH, int L,
                        int H, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dkv<64>(q, k, v, kmask, qmask, dout, lse, delta, dk, dv,
                          BH, L, H, scale, s);
  if (D == 128)
    return launch_dkv<128>(q, k, v, kmask, qmask, dout, lse, delta, dk, dv,
                           BH, L, H, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
