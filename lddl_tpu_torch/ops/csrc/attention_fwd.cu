// Attention forward for Hopper (sm_90a): the port of the two forward
// Pallas kernels in lddl_tpu/ops/flash_attention.py. One kernel body,
// instantiated as two __global__ kernels with a C entry point each, one
// per regime of the reference:
//
//   onekv_fwd_kernel   replaces _onekv_fwd_kernel  (lddl_onekv_fwd)
//   online_fwd_kernel  replaces _fwd_kernel        (lddl_online_fwd)
//
// The backward kernels of both regimes are in online_attention_bwd.cu.
//
// What they compute (per (batch*head) row, as the TPU kernels):
//   S = Q K^T * scale + bias, bias = 0 where kmask > 0 && kmask == qmask,
//       else -1e9 (fp32, added to the scaled fp32 score; never -inf);
//   walk the K/V tiles with a running max m, denominator l and an fp32
//   accumulator, each rescaled by exp(m - m_new); P = exp(S - m_new) is
//   rounded to bf16 before P V; O = acc / max(l, 1e-30) in bf16 and
//   LSE = m + log(max(l, 1e-30)) in fp32.
// The single-block reference takes each row's max over all keys at once;
// the tile walk computes the same function (only the bf16 rounding of P
// differs). No tile is skipped: padded query rows (qmask 0) see every key
// disallowed and spread over all L_pad keys, and a batch row masked
// entirely gives the uniform average, as in the reference.
// Layout: q/k/v/o [B*H, L_pad, D] bf16, masks int32 [B, L_pad], LSE fp32
// [B*H, L_pad]. L_pad is a multiple of 128; D is 64, 128 or 256
// (template; the wrapper zero-pads any other head dim up to one of them).
// onekv_fwd_kernel is built at D=64 and 128 only: the reference's
// single-block regime never takes a wider head.
//
// What bounds them on this card: at the BART path's shape (B=8, H=12,
// L_pad 1024, D=64) the online forward does 25.8 GFLOP of bf16 products
// against 51 MB of operands (26 us at 989 TFLOP/s, 15 us at 3.35 TB/s):
// the tensor cores. At bert_large's largest kernel bin (B=16, H=16,
// L_pad 512, D=64) the single-block forward does 17.2 GFLOP against
// 68 MB (17 and 20 us): the two bounds nearly meet. At D=64 the exp of
// each score costs the SFU about as many cycles as its two products cost
// the tensor cores, so the softmax has to overlap the products.
//
// Design (warp specialisation, hopper_tiles.cuh): a block of three
// warpgroups owns 128 query rows of one (batch*head). Warpgroups 0 and 1
// are consumers with 64 rows each; one thread of warpgroup 2, the
// producer, loads the block's Q once by TMA and then streams K and V in
// STEP-key tiles, with the tile's kmask slice by bulk copy, through a
// ring of NS stages guarded by full/empty mbarriers. Tiles arrive with
// the 128-byte swizzle, which wgmma reads directly: K as the K-major B of
// S = Q K^T, V, through a second descriptor over the same bytes, as the
// MN-major B of P V, so nothing is transposed. Each consumer warpgroup
// computes its 64 x STEP score tile with wgmma m64n64k16 into registers,
// applies scale, bias and the running max there (a row lives in the four
// threads of a quad), and packs P to bf16 in place as the register A
// operand of P V: no score tile passes through shared memory. Per tile,
// Q K^T of tile t and P V of tile t - 1 go out as two wgmma groups back
// to back; the softmax of tile t waits for the first only and runs while
// the second is in flight (O is rescaled once that lands), and the other
// warpgroup's products fill the tensor cores meanwhile. setmaxnreg moves
// registers from the producer (24) to the consumers (240). The epilogue
// writes O / l as bf16 into the warpgroup's own, now dead, Q rows in the
// swizzled layout and stores it by TMA; each row's LSE goes out from
// registers. No atomics: two launches give bit-identical O and LSE.
//
// At D=256 (Plan below) the O accumulator of 64 rows would take 128 fp32
// registers a thread. Beside S and P's fragments that should fit the
// consumers' 240, but ptxas spilled 380-632 bytes and serialised the
// wgmmas in every arrangement tried (the tile loop's two groups, or S,
// softmax and P V one after the other; on its own the loop compiles
// without spills, and staging O's four panels after it brings the
// spill). So at D=256 a block owns 64 query rows, both consumer
// warpgroups compute the same S tile and softmax over all of D, and
// each keeps half of D's columns of O: 64 registers, as at D=128. S is
// computed twice, 1.5x the tensor work of the undivided body. The two
// warpgroups meet at a named barrier before staging their halves of O
// in the block's Q panels, which both read until their last tile;
// warpgroup 0 writes the LSE. Q takes 32 KB and a stage of K and V
// 64 KB: three stages.

#include <math.h>

#include "hopper_tiles.cuh"

namespace {

using namespace lddl_hopper;

constexpr int NCONSUMER = 256;                 // two consumer warpgroups
constexpr int NTHREADS = NCONSUMER + 128;      // + the producer warpgroup
constexpr int ROWS = 128;                      // query rows a block owns
constexpr int STEP = 64;                       // keys of a streamed tile
constexpr int RING_PANEL = STEP * ROW_BYTES;   // 8 KB: one 64-row panel
constexpr int SLICE = STEP * 4;                // a tile's kmask slice
constexpr int CONSUMER_REGS = 240;
constexpr int PRODUCER_REGS = 24;
constexpr float NEG_BIG = -1e9f;
constexpr float LOG2E = 1.4426950408889634f;

static_assert(2 * CONSUMER_REGS * 128 + PRODUCER_REGS * 128 <= 65536,
              "the register file of one SM");

// How the body divides its work and its shared memory at head dim D.
template <int D>
struct Plan {
  static constexpr int DN = D / PANEL;
  // Both consumer warpgroups take the block's rows, each half of D's
  // columns of O (D=256); otherwise each takes 64 rows and all columns.
  static constexpr bool SPLIT = D == 256;
  static constexpr int QROWS = SPLIT ? STEP : ROWS;   // a block's queries
  static constexpr int Q_PANEL = QROWS * ROW_BYTES;   // a panel of Q
  static constexpr int NS = SPLIT ? 3 : 4;            // ring stages
  // Q, the stages of a K and a V tile and of a kmask slice, the
  // barriers, and room to align the base to 1024 bytes.
  static constexpr size_t SMEM = DN * Q_PANEL +
                                 NS * (2 * DN * RING_PANEL + SLICE) +
                                 (2 * NS + 1) * 8 + 1024;
  static_assert(SMEM <= 232448, "227 KB of shared memory");
};

// The scaled score plus its bias, rounded as the reference rounds them:
// the product first, then the sum (no fused multiply-add).
__device__ __forceinline__ float biased(float s, float scale, int km,
                                        int qm) {
  return __fmul_rn(s, scale) + ((km > 0 && km == qm) ? 0.0f : NEG_BIG);
}

// 2^x on the SFU; results below the smallest normal float flush to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One tile's online-softmax update of the thread's two rows (g and g + 8
// of the warpgroup's 64): bias and scale the scores, take the running max
// over the quad that holds each row, turn S into P = exp(S - m_new) in
// place and fold P's row sums into l, rescaled by corr = exp(m - m_new).
// It touches neither O nor the A fragments, so it runs while the P V of
// the previous tile is in flight; rescale() applies corr to O after that.
// l stays the thread's partial sum over its columns until the epilogue.
__device__ __forceinline__ void softmax_tile(float (&sc)[32], const int* km,
                                             int c, int qm0, int qm1,
                                             float scale, float (&m)[2],
                                             float (&l)[2],
                                             float (&corr)[2]) {
  float mx0 = m[0], mx1 = m[1];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int2 k = *reinterpret_cast<const int2*>(km + 8 * j + c);
    sc[4 * j + 0] = biased(sc[4 * j + 0], scale, k.x, qm0);
    sc[4 * j + 1] = biased(sc[4 * j + 1], scale, k.y, qm0);
    sc[4 * j + 2] = biased(sc[4 * j + 2], scale, k.x, qm1);
    sc[4 * j + 3] = biased(sc[4 * j + 3], scale, k.y, qm1);
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j + 0], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  // exp(-inf) = 0 on the first tile, where m is still -inf.
  corr[0] = ex2((m[0] - mx0) * LOG2E);
  corr[1] = ex2((m[1] - mx1) * LOG2E);
  m[0] = mx0;
  m[1] = mx1;
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[4 * j + 0] = ex2((sc[4 * j + 0] - mx0) * LOG2E);
    sc[4 * j + 1] = ex2((sc[4 * j + 1] - mx0) * LOG2E);
    sc[4 * j + 2] = ex2((sc[4 * j + 2] - mx1) * LOG2E);
    sc[4 * j + 3] = ex2((sc[4 * j + 3] - mx1) * LOG2E);
    sum0 += sc[4 * j + 0] + sc[4 * j + 1];
    sum1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  l[0] = l[0] * corr[0] + sum0;
  l[1] = l[1] * corr[1] + sum1;
}

// Scale the O accumulator's rows g and g + 8 by f[0] and f[1].
template <int DN>
__device__ __forceinline__ void rescale(float (&o)[DN][32],
                                        const float (&f)[2]) {
#pragma unroll
  for (int p = 0; p < DN; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[p][4 * j + 0] *= f[0];
      o[p][4 * j + 1] *= f[0];
      o[p][4 * j + 2] *= f[1];
      o[p][4 * j + 3] *= f[1];
    }
}

// S = Q K^T (the warpgroup's 64 query rows, both operands K-major; Q's
// panels q_panel bytes apart) into the open wgmma group; scale_d 0 on
// the first k-step overwrites S.
template <int D>
__device__ __forceinline__ void issue_s(float (&sc)[32], const uint8_t* q,
                                        int q_panel, const uint8_t* k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<0>(sc, kmajor_desc(q + (kk / 4) * q_panel, kk % 4),
                kmajor_desc(k + (kk / 4) * RING_PANEL, kk % 4), kk > 0);
}

// O += P V (P from registers, V's panels from v as an MN-major B) into
// the open wgmma group.
template <int ON>
__device__ __forceinline__ void issue_pv(float (&o)[ON][32],
                                         const uint32_t (&a)[4][4],
                                         const uint8_t* v) {
#pragma unroll
  for (int p = 0; p < ON; ++p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(o[p], a[kk], mnmajor_desc(v + p * RING_PANEL, kk));
}

template <int DN>
__device__ __forceinline__ void fence_all(float (&sc)[32],
                                          uint32_t (&a)[4][4],
                                          float (&o)[DN][32]) {
  fence_regs(sc);
  fence_regs(a);
#pragma unroll
  for (int p = 0; p < DN; ++p) fence_regs(o[p]);
}

template <int D>
__device__ __forceinline__ void fwd_body(
    uint8_t* smem_raw, const CUtensorMap* map_q, const CUtensorMap* map_k,
    const CUtensorMap* map_v, const CUtensorMap* map_o,
    const int* __restrict__ kmask, const int* __restrict__ qmask,
    float* __restrict__ lse, int L, int H, float scale) {
  using P = Plan<D>;
  constexpr int DN = P::DN, NS = P::NS, QROWS = P::QROWS;
  constexpr int Q_PANEL = P::Q_PANEL;
  constexpr int ON = P::SPLIT ? DN / 2 : DN;  // O's panels a warpgroup keeps
  uint8_t* sQ = align_1024(smem_raw);        // DN panels of QROWS rows
  uint8_t* ring = sQ + DN * Q_PANEL;         // per stage: K, then V
  uint8_t* slices = ring + NS * 2 * DN * RING_PANEL;   // kmask
  uint64_t* full = reinterpret_cast<uint64_t*>(slices + NS * SLICE);
  uint64_t* empty = full + NS;
  uint64_t* q_full = empty + NS;

  const int q0 = blockIdx.x * QROWS, bh = blockIdx.y, b = bh / H;
  const int row0 = bh * L;                   // this row's first 2-D row
  const int ntiles = L / STEP;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCONSUMER);
    }
    mbar_init(q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= NCONSUMER) {
    // Producer: Q of the block once, then the K/V ring.
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != NCONSUMER) return;
    mbar_arrive_expect_tx(q_full, DN * Q_PANEL);
    for (int p = 0; p < DN; ++p)
      for (int h = 0; h < QROWS / STEP; ++h)
        tma_load_2d(sQ + p * Q_PANEL + h * RING_PANEL, map_q, p * PANEL,
                    row0 + q0 + h * STEP, q_full);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % NS;
      mbar_wait(&empty[s], ((t / NS) & 1) ^ 1);
      uint8_t* st = ring + s * 2 * DN * RING_PANEL;
      mbar_arrive_expect_tx(&full[s], 2 * DN * RING_PANEL + SLICE);
      for (int p = 0; p < DN; ++p) {
        tma_load_2d(st + p * RING_PANEL, map_k, p * PANEL, row0 + t * STEP,
                    &full[s]);
        tma_load_2d(st + (DN + p) * RING_PANEL, map_v, p * PANEL,
                    row0 + t * STEP, &full[s]);
      }
      bulk_load(slices + s * SLICE, kmask + (size_t)b * L + t * STEP, SLICE,
                &full[s]);
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows [64 qr, 64 qr + 64) of the
  // block (qr = wg; qr = 0 under SPLIT, where the block is those 64 rows)
  // and O's panels [p0, p0 + ON) (all, or half under SPLIT); its thread
  // holds rows r and r + 8 and columns 8j + c, 8j + c + 1 (keys) of each
  // score tile.
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x / 128, wtid = threadIdx.x % 128;
  const int r = 16 * (wtid / 32) + (wtid % 32) / 4, c = 2 * (wtid % 4);
  const int qr = P::SPLIT ? 0 : wg, p0 = P::SPLIT ? wg * ON : 0;
  const int qrow = q0 + STEP * qr + r;
  const int qm0 = qmask[(size_t)b * L + qrow];
  const int qm1 = qmask[(size_t)b * L + qrow + 8];
  const uint8_t* myQ = sQ + qr * RING_PANEL;   // the warpgroup's 64 rows

  float o[ON][32], sc[32];
  uint32_t a[4][4];   // P as bf16 A fragments
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = 0.0f;
#pragma unroll
    for (int p = 0; p < ON; ++p) o[p][i] = 0.0f;
  }
  mbar_wait(q_full, 0);

  // Stage s holds K (DN panels), then V (DN panels); its kmask slice. v_of
  // is the warpgroup's first panel of V.
  auto k_of = [&](int s) { return ring + s * 2 * DN * RING_PANEL; };
  auto v_of = [&](int s) {
    return ring + ((s * 2 + 1) * DN + p0) * RING_PANEL;
  };
  auto kmask_of = [&](int s) {
    return reinterpret_cast<const int*>(slices + s * SLICE);
  };

  float corr[2];
  mbar_wait(&full[0], 0);
  fence_all<ON>(sc, a, o);
  wgmma_fence();
  issue_s<D>(sc, myQ, Q_PANEL, k_of(0));
  wgmma_commit();
  wgmma_wait<0>();
  fence_all<ON>(sc, a, o);
  softmax_tile(sc, kmask_of(0), c, qm0, qm1, scale, m, l, corr);
  acc_to_a(sc, a);

  for (int t = 1; t < ntiles; ++t) {
    const int s = t % NS, prev = (t - 1) % NS;
    mbar_wait(&full[s], (t / NS) & 1);
    // S of this tile, then P V of the previous one, as two groups; the
    // softmax of this tile runs while P V is in flight.
    fence_all<ON>(sc, a, o);
    wgmma_fence();
    issue_s<D>(sc, myQ, Q_PANEL, k_of(s));
    wgmma_commit();
    issue_pv<ON>(o, a, v_of(prev));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
    softmax_tile(sc, kmask_of(s), c, qm0, qm1, scale, m, l, corr);
    wgmma_wait<0>();
    fence_all<ON>(sc, a, o);
    mbar_arrive(&empty[prev]);
    rescale<ON>(o, corr);
    acc_to_a(sc, a);
  }
  const int last = (ntiles - 1) % NS;
  fence_all<ON>(sc, a, o);
  wgmma_fence();
  issue_pv<ON>(o, a, v_of(last));
  wgmma_commit();
  wgmma_wait<0>();
  fence_all<ON>(sc, a, o);
  mbar_arrive(&empty[last]);

  // The rows' denominators (the quad's partial sums), then O = acc / l.
  const float l0 = fmaxf(quad_sum(l[0]), 1e-30f);
  const float l1 = fmaxf(quad_sum(l[1]), 1e-30f);
#pragma unroll
  for (int p = 0; p < ON; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[p][4 * j + 0] /= l0;
      o[p][4 * j + 1] /= l0;
      o[p][4 * j + 2] /= l1;
      o[p][4 * j + 3] /= l1;
    }

  // The warpgroup's Q rows are dead (under SPLIT once the other
  // warpgroup, which reads all of Q's panels, is past its last tile):
  // stage O there, store it by TMA.
  if (P::SPLIT) named_barrier(3, NCONSUMER);
#pragma unroll
  for (int p = 0; p < ON; ++p)
    acc_to_panel(o[p], sQ + (p0 + p) * Q_PANEL + qr * RING_PANEL, wtid);
  fence_proxy_async();
  named_barrier(1 + wg, 128);
  if (wtid == 0) {
    for (int p = p0; p < p0 + ON; ++p)
      tma_store_2d(map_o, sQ + p * Q_PANEL + qr * RING_PANEL, p * PANEL,
                   row0 + q0 + qr * STEP);
    tma_store_commit_and_wait();
  }
  if (wtid % 4 == 0 && (!P::SPLIT || wg == 0)) {
    lse[(size_t)row0 + qrow] = m[0] + logf(l0);
    lse[(size_t)row0 + qrow + 8] = m[1] + logf(l1);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
onekv_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_o,
                 const int* __restrict__ kmask,
                 const int* __restrict__ qmask, float* __restrict__ lse,
                 int L, int H, float scale) {
  extern __shared__ uint8_t smem_raw[];
  fwd_body<D>(smem_raw, &map_q, &map_k, &map_v, &map_o, kmask, qmask, lse,
              L, H, scale);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
online_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  const __grid_constant__ CUtensorMap map_o,
                  const int* __restrict__ kmask,
                  const int* __restrict__ qmask, float* __restrict__ lse,
                  int L, int H, float scale) {
  extern __shared__ uint8_t smem_raw[];
  fwd_body<D>(smem_raw, &map_q, &map_k, &map_v, &map_o, kmask, qmask, lse,
              L, H, scale);
}

template <int D, typename Kernel>
int launch(Kernel kernel, const void* q, const void* k, const void* v,
           const void* km, const void* qm, void* o, void* lse, int BH,
           int L, int H, float scale, cudaStream_t stream) {
  if (!shape_ok(BH, L, ROWS)) return (int)cudaErrorInvalidValue;
  const size_t smem = Plan<D>::SMEM;
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, o};
  cudaError_t err = make_maps(maps, ptrs, 4, BH, L, D);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = L / Plan<D>::QROWS;
  kernel<<<dim3(blocks, BH), NTHREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const int*)km, (const int*)qm,
      (float*)lse, L, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Each returns the cudaError_t of
// its launch: 0 on success. Inputs are checked by the Python wrapper.
extern "C" {

int lddl_onekv_fwd(const void* q, const void* k, const void* v,
                   const void* kmask, const void* qmask, void* o, void* lse,
                   int BH, int L, int H, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(onekv_fwd_kernel<64>, q, k, v, kmask, qmask, o, lse,
                      BH, L, H, scale, s);
  if (D == 128)
    return launch<128>(onekv_fwd_kernel<128>, q, k, v, kmask, qmask, o, lse,
                       BH, L, H, scale, s);
  return (int)cudaErrorInvalidValue;
}

int lddl_online_fwd(const void* q, const void* k, const void* v,
                    const void* kmask, const void* qmask, void* o, void* lse,
                    int BH, int L, int H, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(online_fwd_kernel<64>, q, k, v, kmask, qmask, o, lse,
                      BH, L, H, scale, s);
  if (D == 128)
    return launch<128>(online_fwd_kernel<128>, q, k, v, kmask, qmask, o,
                       lse, BH, L, H, scale, s);
  if (D == 256)
    return launch<256>(online_fwd_kernel<256>, q, k, v, kmask, qmask, o,
                       lse, BH, L, H, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
