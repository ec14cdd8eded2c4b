// Device helpers of the port's single-block backward kernels
// (onekv_attention.cu): the wmma fragment types, the shared-memory row
// padding, tile loads and stores between device memory and shared memory,
// and the two 16-row warp products those kernels are built from.
//
// Conventions: bf16 tiles in shared memory are row-major with leading
// dimension D + PAD_H (16 bytes of padding per row, so rows start on
// different banks); fp32 tiles use + PAD_F. A "strip" is the 16 rows of a
// tile that one warp owns. All products are bf16 x bf16 -> fp32 on the
// tensor cores through nvcuda::wmma (16x16x16).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace lddl_attn {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int PAD_H = 8;        // bf16 row padding (16 bytes)
constexpr int PAD_F = 4;        // fp32 row padding (16 bytes)
constexpr float NEG_BIG = -1e9f;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    AFrag;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    BRowFrag;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    BColFrag;

// Copy rows [0, ROWS) x D of a row-major [*, D] bf16 matrix into shared
// memory with row stride D + PAD_H, 16 bytes per thread per step.
template <int ROWS, int D, int NTHREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src) {
  constexpr int VEC = 8;
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += NTHREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    *reinterpret_cast<uint4*>(dst + r * (D + PAD_H) + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
  }
}

// Warp product of a 16-row strip: out[16, N] (fp32, leading dimension
// ldo) = a[16, D] times b^T, a and b ([N, D]) bf16 with leading dimension
// D + PAD_H.
template <int D, int N>
__device__ __forceinline__ void strip_abt(float* out, int ldo, const bf16* a,
                                          const bf16* b) {
  constexpr int LDH = D + PAD_H;
  AccFrag acc[N / 16];
#pragma unroll
  for (int j = 0; j < N / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    AFrag fa;
    wmma::load_matrix_sync(fa, a + kk, LDH);
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      BColFrag fb;
      wmma::load_matrix_sync(fb, b + j * 16 * LDH + kk, LDH);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < N / 16; ++j)
    wmma::store_matrix_sync(out + j * 16, acc[j], ldo, wmma::mem_row_major);
}

// acc[D/16] (a 16 x D strip) += a[16, K] (bf16, leading dimension lda)
// times b[K, D] (bf16, leading dimension D + PAD_H).
template <int D, int K>
__device__ __forceinline__ void strip_ab_acc(AccFrag* acc, const bf16* a,
                                             int lda, const bf16* b) {
  constexpr int LDH = D + PAD_H;
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    AFrag fa;
    wmma::load_matrix_sync(fa, a + kk, lda);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      BRowFrag fb;
      wmma::load_matrix_sync(fb, b + kk * LDH + j * 16, LDH);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

// Write a (NTHREADS / 32 * 16) x D fp32 accumulator tile, held as one
// 16-row strip of fragments per warp, to device memory as bf16, staged
// through shared memory (stage: fp32, leading dimension D + PAD_F).
template <int D, int NTHREADS>
__device__ __forceinline__ void store_acc_tile(bf16* dst, AccFrag* acc,
                                               float* stage) {
  constexpr int LDO = D + PAD_F;
  constexpr int ROWS = NTHREADS / 32 * 16;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(stage + warp * 16 * LDO + j * 16, acc[j], LDO,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    dst[(size_t)r * D + c] = __float2bfloat16(stage[r * LDO + c]);
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace lddl_attn

// The message of a cudaError_t returned by a C entry point (ctypes).
extern "C" const char* lddl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
