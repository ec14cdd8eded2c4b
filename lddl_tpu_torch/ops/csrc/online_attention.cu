// Long-sequence attention forward for Hopper (sm_90a): the port of the
// online-softmax forward Pallas kernel in lddl_tpu/ops/flash_attention.py,
// one __global__ kernel and one C entry point:
//
//   online_fwd_kernel      replaces _fwd_kernel      (lddl_online_fwd)
//
// The two backward kernels of the regime (_bwd_dq_kernel and
// _bwd_dkv_kernel) are in online_attention_bwd.cu.
//
// What it computes (identical to the TPU kernel, per (batch*head) row):
//   S   = Q K^T * scale + bias,  bias = 0 where kmask > 0 && kmask == qmask,
//         else -1e9 (fp32, added to the scaled fp32 score; never -inf)
//   walk K/V tiles with a running max m, denominator l and an fp32
//   accumulator, all rescaled by exp(m - m_new); P = exp(S - m_new) is
//   cast to V's dtype before P V. O = acc / max(l, 1e-30) in the input
//   dtype, LSE = m + log(max(l, 1e-30)) in fp32.
// Layout: q/k/v/o [B*H, L_pad, D] bf16, masks int32 [B, L_pad], LSE fp32
// [B*H, L_pad]. L_pad is a multiple of 128; D is 64 or 128 (template).
//
// What bounds it on this card: at the BART path's shape (B=8, H=12,
// L_pad 1024, D=64) the forward needs 25.8 GFLOP of bf16 products against
// ~51 MB of operands (26 us at 989 TFLOP/s, 15 us at 3.35 TB/s): it is
// bound by the tensor cores, and the cost that grows with L is the
// re-read of K/V by every block of a row, L_pad / 128 times per row.
//
// Tile sizes (the port's own; the reference's _block_sizes was tuned for
// TPU VMEM): a block of 8 warps owns 128 rows (16 per warp) and walks the
// other side in 64-wide tiles. 128 rows halve the number of times each
// block-row re-reads the streamed operand against 64-row blocks, which
// matters at L_pad >= 1024 where that stream dominates; 64 columns keep a
// lane pair's share of a score row at 32 registers. The fp32 score strip
// is reused in place for the bf16 P tile, with a bf16 leading dimension
// of twice the fp32 one, so shared memory is 105 KB at D=64 (room for two
// blocks per SM) and 169 KB at D=128. Simple and correct first: wmma
// products, no TMA, no wgmma, no pipelining of the tile loads.
//
// Padded query rows (qmask 0) see every key disallowed and average
// uniformly over all L_pad keys, as in the reference; fully masked tiles
// are never skipped, since such rows need them.

#include <math.h>

#include "attention_tiles.cuh"

namespace {

using namespace lddl_attn;

constexpr int NTHREADS = 256;       // 8 warps
constexpr int ROWS = 128;           // rows a block owns, 16 per warp
constexpr int STEP = 64;            // width of the tile walked per step
constexpr int LDS = STEP + PAD_F;   // ld of the fp32 score strip
constexpr int LDB = 2 * LDS;        // ld of the bf16 tile written over it

template <int D>
constexpr size_t bf16_rows_bytes(int rows) {
  return (size_t)rows * (D + PAD_H) * sizeof(bf16);
}

constexpr size_t score_bytes() { return (size_t)ROWS * LDS * sizeof(float); }

template <int D>
constexpr size_t stage_bytes() {
  return (size_t)ROWS * (D + PAD_F) * sizeof(float);
}

// Every region below is a multiple of 128 bytes, so each starts aligned.
template <int D>
constexpr size_t fwd_smem_bytes() {
  return bf16_rows_bytes<D>(ROWS)            // Q
         + 2 * bf16_rows_bytes<D>(STEP)      // K, V
         + score_bytes()                     // S, then P
         + stage_bytes<D>()                  // O accumulator
         + (ROWS + STEP) * sizeof(int);      // masks
}

static_assert(fwd_smem_bytes<128>() <= 232448,
              "227 KB of shared memory per block");

template <int D>
__global__ void __launch_bounds__(NTHREADS)
online_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ kmask,
                  const int* __restrict__ qmask, bf16* __restrict__ o,
                  float* __restrict__ lse, int L, int H, float scale) {
  constexpr int LDH = D + PAD_H;
  constexpr int LDO = D + PAD_F;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + ROWS * LDH;
  bf16* sV = sK + STEP * LDH;
  float* sS = reinterpret_cast<float*>(sV + STEP * LDH);
  float* sO = sS + ROWS * LDS;
  int* sQm = reinterpret_cast<int*>(sO + ROWS * LDO);
  int* sKm = sQm + ROWS;

  const int q0 = blockIdx.x * ROWS, bh = blockIdx.y, b = bh / H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)bh * L * D;

  load_tile<ROWS, D, NTHREADS>(sQ, q + base + (size_t)q0 * D);
  if (threadIdx.x < ROWS)
    sQm[threadIdx.x] = qmask[(size_t)b * L + q0 + threadIdx.x];
  for (int i = threadIdx.x; i < ROWS * LDO; i += NTHREADS) sO[i] = 0.0f;
  __syncthreads();

  // Lane pair (2r, 2r+1) of warp w owns block row 16w + r; each lane takes
  // half of the row's 64 columns of a step.
  const int row = warp * 16 + lane / 2, half = lane & 1;
  const int my_qm = sQm[row];
  float* s_strip = sS + warp * 16 * LDS;
  const bf16* p_strip = reinterpret_cast<bf16*>(sS) + warp * 16 * LDB;
  const float* srow = sS + row * LDS + half * 32;
  bf16* prow = reinterpret_cast<bf16*>(sS) + row * LDB + half * 32;
  float* orow = sO + row * LDO + half * (D / 2);
  float m_run = -INFINITY, l_run = 0.0f;

  for (int k0 = 0; k0 < L; k0 += STEP) {
    load_tile<STEP, D, NTHREADS>(sK, k + base + (size_t)k0 * D);
    load_tile<STEP, D, NTHREADS>(sV, v + base + (size_t)k0 * D);
    if (threadIdx.x < STEP)
      sKm[threadIdx.x] = kmask[(size_t)b * L + k0 + threadIdx.x];
    __syncthreads();

    strip_abt<D, STEP>(s_strip, LDS, sQ + warp * 16 * LDH, sK);
    __syncwarp();

    const int* km = sKm + half * 32;
    float s[32];
    float tmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const bool ok = km[c] > 0 && km[c] == my_qm;
      s[c] = srow[c] * scale + (ok ? 0.0f : NEG_BIG);
      tmax = fmaxf(tmax, s[c]);
    }
    __syncwarp();   // the strip is read before P overwrites it
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m_run, tmax);
    const float corr = expf(m_run - m_new);
    float tsum = 0.0f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = expf(s[c] - m_new);
      tsum += p;
      prow[c] = __float2bfloat16(p);
    }
    tsum += __shfl_xor_sync(0xffffffffu, tsum, 1);
    l_run = l_run * corr + tsum;
    m_run = m_new;
#pragma unroll
    for (int c = 0; c < D / 2; ++c) orow[c] *= corr;
    __syncwarp();

    // O strip += P strip V (accumulated in fp32 through shared memory).
    AccFrag acc[D / 16];
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wmma::load_matrix_sync(acc[j], sO + warp * 16 * LDO + j * 16, LDO,
                             wmma::mem_row_major);
    strip_ab_acc<D, STEP>(acc, p_strip, LDB, sV);
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wmma::store_matrix_sync(sO + warp * 16 * LDO + j * 16, acc[j], LDO,
                              wmma::mem_row_major);
    __syncthreads();
  }

  const float l = fmaxf(l_run, 1e-30f);
  const float inv = 1.0f / l;
  bf16* out = o + base + (size_t)(q0 + row) * D + half * (D / 2);
#pragma unroll
  for (int c = 0; c < D / 2; ++c) out[c] = __float2bfloat16(orow[c] * inv);
  if (half == 0) lse[(size_t)bh * L + q0 + row] = m_run + logf(l);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* km,
               const void* qm, void* o, void* lse, int BH, int L, int H,
               float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<D>();
  cudaError_t err = set_smem(online_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  online_fwd_kernel<D><<<dim3(L / ROWS, BH), NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)km,
      (const int*)qm, (bf16*)o, (float*)lse, L, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Each returns the cudaError_t of
// its launch: 0 on success. Inputs are checked by the Python wrapper.
extern "C" {

int lddl_online_fwd(const void* q, const void* k, const void* v,
                    const void* kmask, const void* qmask, void* o, void* lse,
                    int BH, int L, int H, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_fwd<64>(q, k, v, kmask, qmask, o, lse, BH, L, H, scale, s);
  if (D == 128)
    return launch_fwd<128>(q, k, v, kmask, qmask, o, lse, BH, L, H, scale,
                           s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
