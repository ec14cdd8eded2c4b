// Single-block attention backward for Hopper (sm_90a): the port of the
// backward Pallas kernel of the single-block regime in
// lddl_tpu/ops/flash_attention.py. The regime's forward
// (_onekv_fwd_kernel) is onekv_fwd_kernel in attention_fwd.cu.
//
//   onekv_bwd_dkv_kernel  } together replace _onekv_bwd_kernel
//   onekv_bwd_dq_kernel   }
//
// What they compute (identical to the TPU kernel, per (batch*head) row):
//   S   = Q K^T * scale + bias,  bias = 0 where kmask > 0 && kmask == qmask,
//         else -1e9 (fp32, added to the scaled fp32 score; never -inf)
//   P   = exp(S - LSE); dV = P^T dO; dP = dO V^T;
//   dS  = P * (dP - delta) * scale, cast to the input dtype;
//   dQ  = dS K; dK = dS^T Q     (delta = rowsum(dO * O), computed outside)
// Layout: q/k/v/dO/dQ/dK/dV [B*H, L_pad, D] bf16, masks int32 [B, L_pad],
// LSE and delta fp32 [B*H, L_pad]. L_pad is a multiple of 128.
//
// What bounds them on this card: at the main path's shapes (L_pad 256-512,
// D 64) the backward does ~43 GFLOP of bf16 products per bert_large layer
// call (B=16, H=16, L=512): the tensor cores. The TPU kernel held a whole
// [L, L] fp32 score row in VMEM; on Hopper one [512, 512] fp32 tile is
// 1 MiB, far above the 227 KB of shared memory a block may use.
//
// What the design does about it: one block of 4 warps per (bh, 64-row
// tile), walking 64-wide tiles of the other side, so no [L, L] tile
// exists. The products run on the tensor cores through nvcuda::wmma
// (bf16 x bf16 -> fp32, 16x16x16). Each warp owns 16 rows. The backward
// avoids atomics, so runs are reproducible: a dK/dV kernel takes one
// block per (bh, KV tile) and walks the Q tiles; a dQ kernel takes one
// block per (bh, Q tile) and walks the K/V tiles. That recomputes S and
// dP once more than the TPU's fused kernel (7 products instead of 5).
// This is the simple, correct first version: no TMA, no wgmma, no
// pipelining of the tile loads.
//
// Padded query rows (qmask 0) see every key disallowed and spread
// uniformly over all L_pad keys, as in the reference; fully masked tiles
// are never skipped, since such rows need them.

#include <math.h>

#include "attention_tiles.cuh"

namespace {

using namespace lddl_attn;

constexpr int TILE = 64;        // rows of a Q or K/V tile
constexpr int NTHREADS = 128;   // 4 warps, 16 tile rows each
constexpr int LDP = TILE + PAD_H;   // ld of a bf16 [64, 64] tile
constexpr int LDS = TILE + PAD_F;   // ld of an fp32 [64, 64] tile

// Every region below is a multiple of 128 bytes, so each starts aligned.
template <int D>
constexpr size_t bf16_tile_bytes() {
  return (size_t)TILE * (D + PAD_H) * sizeof(bf16);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return 4 * bf16_tile_bytes<D>()                         // K, V, Q, dO
         + 2 * (size_t)TILE * LDS * sizeof(float)         // S^T, dP^T
         + 2 * (size_t)TILE * LDP * sizeof(bf16)          // P^T, dS^T
         + (size_t)TILE * (D + PAD_F) * sizeof(float)     // output stage
         + 4 * TILE * sizeof(int);                        // masks, lse, delta
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return dkv_smem_bytes<D>() - (size_t)TILE * LDP * sizeof(bf16);  // no P
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
onekv_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const int* __restrict__ kmask,
                     const int* __restrict__ qmask,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int L, int H, float scale) {
  constexpr int LDH = D + PAD_H;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + TILE * LDH;
  bf16* sQ = sV + TILE * LDH;
  bf16* sdO = sQ + TILE * LDH;
  float* sS = reinterpret_cast<float*>(sdO + TILE * LDH);
  float* sdP = sS + TILE * LDS;
  bf16* sP = reinterpret_cast<bf16*>(sdP + TILE * LDS);
  bf16* sdS = sP + TILE * LDP;
  float* stage = reinterpret_cast<float*>(sdS + TILE * LDP);
  int* sKm = reinterpret_cast<int*>(stage + TILE * (D + PAD_F));
  int* sQm = sKm + TILE;
  float* sLse = reinterpret_cast<float*>(sQm + TILE);
  float* sDelta = sLse + TILE;

  const int k0 = blockIdx.x * TILE, bh = blockIdx.y, b = bh / H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)bh * L * D;

  load_tile<TILE, D, NTHREADS>(sK, k + base + (size_t)k0 * D);
  load_tile<TILE, D, NTHREADS>(sV, v + base + (size_t)k0 * D);
  if (threadIdx.x < TILE) sKm[threadIdx.x] = kmask[(size_t)b * L + k0 + threadIdx.x];

  // Warp w owns key rows [16w, 16w + 16) of this tile; its lane pair
  // (2r, 2r+1) owns key row 16w + r and half of the 64 query columns.
  const int row = warp * 16 + lane / 2, half = lane & 1;
  AccFrag dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.0f);
    wmma::fill_fragment(dv_acc[j], 0.0f);
  }

  for (int q0 = 0; q0 < L; q0 += TILE) {
    load_tile<TILE, D, NTHREADS>(sQ, q + base + (size_t)q0 * D);
    load_tile<TILE, D, NTHREADS>(sdO, dout + base + (size_t)q0 * D);
    if (threadIdx.x < TILE) {
      sQm[threadIdx.x] = qmask[(size_t)b * L + q0 + threadIdx.x];
      sLse[threadIdx.x] = lse[(size_t)bh * L + q0 + threadIdx.x];
      sDelta[threadIdx.x] = delta[(size_t)bh * L + q0 + threadIdx.x];
    }
    __syncthreads();

    // S^T strip = K_w Q^T and dP^T strip = V_w dO^T, both [16 keys, 64 q].
    strip_abt<D, TILE>(sS + warp * 16 * LDS, LDS, sK + warp * 16 * LDH,
                       sQ);
    strip_abt<D, TILE>(sdP + warp * 16 * LDS, LDS, sV + warp * 16 * LDH,
                       sdO);
    __syncwarp();

    const int my_km = sKm[row];
#pragma unroll 8
    for (int c = half * 32; c < half * 32 + 32; ++c) {
      const bool ok = my_km > 0 && my_km == sQm[c];
      const float st = sS[row * LDS + c] * scale + (ok ? 0.0f : NEG_BIG);
      const float pt = expf(st - sLse[c]);
      sP[row * LDP + c] = __float2bfloat16(pt);
      const float dst = pt * (sdP[row * LDS + c] - sDelta[c]) * scale;
      sdS[row * LDP + c] = __float2bfloat16(dst);
    }
    __syncwarp();

    // dV += P^T dO; dK += dS^T Q.
    strip_ab_acc<D, TILE>(dv_acc, sP + warp * 16 * LDP, LDP, sdO);
    strip_ab_acc<D, TILE>(dk_acc, sdS + warp * 16 * LDP, LDP, sQ);
    __syncthreads();
  }

  store_acc_tile<D, NTHREADS>(dk + base + (size_t)k0 * D, dk_acc, stage);
  __syncthreads();
  store_acc_tile<D, NTHREADS>(dv + base + (size_t)k0 * D, dv_acc, stage);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
onekv_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const int* __restrict__ kmask,
                    const int* __restrict__ qmask,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int L, int H, float scale) {
  constexpr int LDH = D + PAD_H;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + TILE * LDH;
  bf16* sK = sdO + TILE * LDH;
  bf16* sV = sK + TILE * LDH;
  float* sS = reinterpret_cast<float*>(sV + TILE * LDH);
  float* sdP = sS + TILE * LDS;
  bf16* sdS = reinterpret_cast<bf16*>(sdP + TILE * LDS);
  float* stage = reinterpret_cast<float*>(sdS + TILE * LDP);
  int* sKm = reinterpret_cast<int*>(stage + TILE * (D + PAD_F));
  int* sQm = sKm + TILE;
  float* sLse = reinterpret_cast<float*>(sQm + TILE);
  float* sDelta = sLse + TILE;

  const int q0 = blockIdx.x * TILE, bh = blockIdx.y, b = bh / H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)bh * L * D;

  load_tile<TILE, D, NTHREADS>(sQ, q + base + (size_t)q0 * D);
  load_tile<TILE, D, NTHREADS>(sdO, dout + base + (size_t)q0 * D);
  if (threadIdx.x < TILE) {
    sQm[threadIdx.x] = qmask[(size_t)b * L + q0 + threadIdx.x];
    sLse[threadIdx.x] = lse[(size_t)bh * L + q0 + threadIdx.x];
    sDelta[threadIdx.x] = delta[(size_t)bh * L + q0 + threadIdx.x];
  }
  __syncthreads();

  // Lane pair (2r, 2r+1) of warp w owns query row 16w + r.
  const int row = warp * 16 + lane / 2, half = lane & 1;
  const int my_qm = sQm[row];
  const float my_lse = sLse[row], my_delta = sDelta[row];
  AccFrag dq_acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(dq_acc[j], 0.0f);

  for (int k0 = 0; k0 < L; k0 += TILE) {
    load_tile<TILE, D, NTHREADS>(sK, k + base + (size_t)k0 * D);
    load_tile<TILE, D, NTHREADS>(sV, v + base + (size_t)k0 * D);
    if (threadIdx.x < TILE) sKm[threadIdx.x] = kmask[(size_t)b * L + k0 + threadIdx.x];
    __syncthreads();

    // S = Q K^T and dP = dO V^T.
    strip_abt<D, TILE>(sS + warp * 16 * LDS, LDS, sQ + warp * 16 * LDH,
                       sK);
    strip_abt<D, TILE>(sdP + warp * 16 * LDS, LDS, sdO + warp * 16 * LDH,
                       sV);
    __syncwarp();

#pragma unroll 8
    for (int c = half * 32; c < half * 32 + 32; ++c) {
      const bool ok = sKm[c] > 0 && sKm[c] == my_qm;
      const float s = sS[row * LDS + c] * scale + (ok ? 0.0f : NEG_BIG);
      const float p = expf(s - my_lse);
      const float ds = p * (sdP[row * LDS + c] - my_delta) * scale;
      sdS[row * LDP + c] = __float2bfloat16(ds);
    }
    __syncwarp();

    // dQ += dS K.
    strip_ab_acc<D, TILE>(dq_acc, sdS + warp * 16 * LDP, LDP, sK);
    __syncthreads();
  }

  store_acc_tile<D, NTHREADS>(dq + base + (size_t)q0 * D, dq_acc, stage);
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* km,
               const void* qm, const void* dout, const void* lse,
               const void* delta, void* dq, void* dk, void* dv, int BH,
               int L, int H, float scale, cudaStream_t stream) {
  const size_t smem_dkv = dkv_smem_bytes<D>(), smem_dq = dq_smem_bytes<D>();
  cudaError_t err = set_smem(onekv_bwd_dkv_kernel<D>, smem_dkv);
  if (err == cudaSuccess) err = set_smem(onekv_bwd_dq_kernel<D>, smem_dq);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(L / TILE, BH);
  onekv_bwd_dkv_kernel<D><<<grid, NTHREADS, smem_dkv, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)km,
      (const int*)qm, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (bf16*)dk, (bf16*)dv, L, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  onekv_bwd_dq_kernel<D><<<grid, NTHREADS, smem_dq, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)km,
      (const int*)qm, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (bf16*)dq, L, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Each returns the cudaError_t of
// its launches: 0 on success. Inputs are checked by the Python wrapper.
extern "C" {

int lddl_onekv_bwd(const void* q, const void* k, const void* v,
                   const void* kmask, const void* qmask, const void* dout,
                   const void* lse, const void* delta, void* dq, void* dk,
                   void* dv, int BH, int L, int H, int D, float scale,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_bwd<64>(q, k, v, kmask, qmask, dout, lse, delta, dq, dk, dv, BH, L, H, scale, s);
  if (D == 128)
    return launch_bwd<128>(q, k, v, kmask, qmask, dout, lse, delta, dq, dk, dv, BH, L, H, scale, s);
  return (int)cudaErrorInvalidValue;
}
}  // extern "C"
