// fp32 attention for Hopper (sm_90a) in SIMT fp32 FFMA, at D=256: the
// fp32 builds of the online forward and the online backward pair of
// lddl_tpu/ops/flash_attention.py at the one width whose 3xTF32 tiles do
// not fit shared memory, beside the bf16 kernels of attention_fwd.cu and
// online_attention_bwd.cu. At D=64 and 128 the fp32 kernels run on the
// tensor cores in 3xTF32: the forwards in attention_f32_fwd.cu, the
// backward of both regimes in attention_f32_bwd.cu. Three kernel bodies,
// each instantiated under the bf16 set's online names with an _f32 suffix,
// so that the profiler tells them apart, with a C entry point per kernel
// call of the bf16 set:
//
//   online_fwd_f32_kernel      replaces _fwd_kernel       (lddl_online_fwd_f32, D=256)
//   online_bwd_dq_f32_kernel   replaces _bwd_dq_kernel    (lddl_online_bwd_dq_f32, D=256)
//   online_bwd_dkv_f32_kernel  replaces _bwd_dkv_kernel   (lddl_online_bwd_dkv_f32, D=256)
//
// What they compute: the bf16 kernels' function (attention_fwd.cu and
// online_attention_bwd.cu say it in full) on fp32 operands, where the
// reference's casts of P and dS to the stored dtype are no-ops:
//   S  = Q K^T * scale + bias, bias = 0 where kmask > 0 && kmask == qmask,
//        else -1e9 (fp32, added to the scaled score; never -inf);
//   fwd: walk the K/V tiles with a running max m, denominator l and an
//        fp32 accumulator, each rescaled by exp(m - m_new);
//        O = acc / max(l, 1e-30), LSE = m + log(max(l, 1e-30));
//   P  = exp(S - LSE), dP = dO V^T, dS = P (dP - delta) scale;
//   dq:  walk the K/V tiles, dQ += dS K;
//   dkv: walk the Q/dO tiles, dV += P^T dO, dK += dS^T Q.
// expf and logf, not the fast-math intrinsics. No tile is skipped: padded
// query rows (qmask 0) see every key disallowed and spread over all L_pad
// keys, as in the reference. No atomics: every output element is written
// by one thread of one block, and each block sums in a fixed order, so
// two launches give bit-identical results.
// Layout: q/k/v/o/dO/dQ/dK/dV [B*H, L_pad, D] fp32, masks int32
// [B, L_pad], LSE and delta (rowsum(dO * O), computed outside) fp32
// [B*H, L_pad]. L_pad is a multiple of 128; D is 256 (template; the
// wrapper zero-pads any head dim between 129 and 255 up to it).
//
// What bounds them on this card: every product is an fp32 FFMA on the
// CUDA cores, 66.9 TFLOP/s. At phase 16's shape (B=8, H=3, L_pad 1024,
// D=256) the forward does 25.8 GFLOP against 101 MB of operands: 0.39 ms
// of FFMA against 0.03 ms of bytes; the CUDA cores bound it. A 3xTF32 build
// does not fit: a 64-row item takes 128 KB in hi and lo, and a 64 x 256
// fp32 O with a tile's partial product 256 registers a thread.
//
// Design (SIMT, a simple kernel first): a block of 256 threads, a 16 x 16
// grid, owns ROWS = 64 rows of one (batch*head): queries (fwd, dq) or
// keys (dkv). It stages its own rows in shared memory once and walks the
// other side in tiles of COLS = 32 rows, so that two staged fp32 tiles of
// 256 columns fit beside the block's own rows. Staged rows are padded to
// D + 1 floats, so that the 16 threads of a row group, reading 16 rows at
// one column, hit 16 banks. Each thread owns a 4 x (COLS/16) patch of
// every score tile (rows ty*4 + i, columns tx + 16 j): its products run
// down D in order, and a row's max and sum are finished by shuffles over
// the 16 threads of a half-warp.
// P (fwd), dS (dq), or P^T and dS^T (dkv) then pass through shared memory
// to the output products, where a thread owns a 4 x (D/16) patch of the
// block's output rows (columns tx + 16 c) in registers.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int TX = 16;              // threads along a row group
constexpr int TY = 16;              // row groups
constexpr int NTHREADS = TX * TY;
constexpr int RPT = 4;              // rows a thread owns
constexpr int ROWS = TY * RPT;      // rows a block owns
constexpr float NEG_BIG = -1e9f;

// Tile widths at head dim D: COLS streamed rows a tile, CPT score columns
// and DPT output columns a thread owns, LD the padded row stride (floats)
// of a staged [rows][D] tile, LDS that of a staged [ROWS][COLS] score
// tile.
template <int D>
struct Tile {
  static constexpr int COLS = 32;
  static constexpr int CPT = COLS / TX;
  static constexpr int DPT = D / TX;
  static constexpr int LD = D + 1;
  static constexpr int LDS = COLS + 1;
};

// Shared memory of each body, in bytes.
template <int D>
struct Smem {
  using T = Tile<D>;
  static constexpr size_t FWD =
      sizeof(float) * ((ROWS + 2 * T::COLS) * T::LD + ROWS * T::LDS) +
      sizeof(int) * T::COLS;
  static constexpr size_t DQ =
      sizeof(float) * ((2 * ROWS + 2 * T::COLS) * T::LD + ROWS * T::LDS) +
      sizeof(int) * T::COLS;
  static constexpr size_t DKV =
      sizeof(float) * ((2 * ROWS + 2 * T::COLS) * T::LD +
                       2 * ROWS * T::LDS + 2 * T::COLS) +
      sizeof(int) * T::COLS;
};

// rows x D contiguous fp32 from global memory into a staged tile of
// stride D + 1 (16-byte loads: D is a multiple of 4 and the operands are
// 16-byte aligned).
template <int D>
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ src,
                                      int rows) {
  const float4* src4 = reinterpret_cast<const float4*>(src);
  const int n4 = rows * D / 4;
  for (int i = threadIdx.x; i < n4; i += NTHREADS) {
    const float4 x = src4[i];
    const int r = (4 * i) / D, c = (4 * i) % D;
    float* p = dst + r * Tile<D>::LD + c;
    p[0] = x.x;
    p[1] = x.y;
    p[2] = x.z;
    p[3] = x.w;
  }
}

// s[i][j] = sum over d of a[ty*RPT + i][d] * b[tx + TX*j][d], both staged
// with stride D + 1, summed in the order of d.
template <int D, int CPT>
__device__ __forceinline__ void products(float (&s)[RPT][CPT],
                                         const float* a, const float* b,
                                         int ty, int tx) {
  constexpr int LD = Tile<D>::LD;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
  const float* arow = a + ty * RPT * LD;
  const float* brow = b + tx * LD;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[RPT], bv[CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) av[i] = arow[i * LD + d];
#pragma unroll
    for (int j = 0; j < CPT; ++j) bv[j] = brow[j * TX * LD + d];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][c] += sum over n < N of p[ty*RPT + i][n] * x[n][tx + TX*c]: p a
// staged score tile of stride LDS, x staged with stride D + 1; summed in
// the order of n.
template <int D, int N>
__device__ __forceinline__ void accumulate(float (&acc)[RPT][D / TX],
                                           const float* p, const float* x,
                                           int ty, int tx) {
  constexpr int LD = Tile<D>::LD, LDS = Tile<D>::LDS, DPT = D / TX;
  const float* prow = p + ty * RPT * LDS;
#pragma unroll 2
  for (int n = 0; n < N; ++n) {
    float xv[DPT];
#pragma unroll
    for (int c = 0; c < DPT; ++c) xv[c] = x[n * LD + tx + TX * c];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float pv = prow[i * LDS + n];
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(pv, xv[c], acc[i][c]);
    }
  }
}

// Max and sum over the TX threads of a row group (a half-warp: lanes that
// differ in their low four bits). Every lane gets the same value.
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float bias(int km, int qm) {
  return (km > 0 && km == qm) ? 0.f : NEG_BIG;
}

// The forward: a block owns ROWS queries of one (batch*head) and walks
// every K/V tile.
template <int D>
__device__ __forceinline__ void fwd_body(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ kmask,
    const int* __restrict__ qmask, float* __restrict__ o,
    float* __restrict__ lse, int L, int H, float scale) {
  using T = Tile<D>;
  constexpr int COLS = T::COLS, CPT = T::CPT, DPT = T::DPT, LD = T::LD,
                LDS = T::LDS;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [ROWS][LD]
  float* ks = qs + ROWS * LD;                   // [COLS][LD]
  float* vs = ks + COLS * LD;                   // [COLS][LD]
  float* ps = vs + COLS * LD;                   // [ROWS][LDS]
  int* kms = reinterpret_cast<int*>(ps + ROWS * LDS);  // [COLS]

  const int bh = blockIdx.y, b = bh / H, q0 = blockIdx.x * ROWS;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const size_t base = (size_t)bh * L * D;
  stage<D>(qs, q + base + (size_t)q0 * D, ROWS);

  int qm[RPT];
  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    qm[i] = qmask[(size_t)b * L + q0 + ty * RPT + i];
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += COLS) {
    __syncthreads();  // the last tile's K, V and P are read
    stage<D>(ks, k + base + (size_t)k0 * D, COLS);
    stage<D>(vs, v + base + (size_t)k0 * D, COLS);
    if (threadIdx.x < COLS)
      kms[threadIdx.x] = kmask[(size_t)b * L + k0 + threadIdx.x];
    __syncthreads();

    float s[RPT][CPT];
    products<D, CPT>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = s[i][j] * scale + bias(kms[tx + TX * j], qm[i]);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty * RPT + i) * LDS + tx + TX * j] = p;
      }
      l[i] = l[i] * corr + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    accumulate<D, COLS>(acc, ps, vs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    const float li = fmaxf(l[i], 1e-30f);
    float* orow = o + base + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) orow[tx + TX * c] = acc[i][c] / li;
    if (tx == 0) lse[(size_t)bh * L + row] = m[i] + logf(li);
  }
}

// dQ: a block owns ROWS queries of one (batch*head) and walks every K/V
// tile.
template <int D>
__device__ __forceinline__ void dq_body(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ kmask,
    const int* __restrict__ qmask, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int L, int H, float scale) {
  using T = Tile<D>;
  constexpr int COLS = T::COLS, CPT = T::CPT, DPT = T::DPT, LD = T::LD,
                LDS = T::LDS;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [ROWS][LD]
  float* dos = qs + ROWS * LD;                  // [ROWS][LD]
  float* ks = dos + ROWS * LD;                  // [COLS][LD]
  float* vs = ks + COLS * LD;                   // [COLS][LD]
  float* dss = vs + COLS * LD;                  // [ROWS][LDS]
  int* kms = reinterpret_cast<int*>(dss + ROWS * LDS);  // [COLS]

  const int bh = blockIdx.y, b = bh / H, q0 = blockIdx.x * ROWS;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const size_t base = (size_t)bh * L * D;
  stage<D>(qs, q + base + (size_t)q0 * D, ROWS);
  stage<D>(dos, dout + base + (size_t)q0 * D, ROWS);

  int qm[RPT];
  float lse_r[RPT], delta_r[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    qm[i] = qmask[(size_t)b * L + row];
    lse_r[i] = lse[(size_t)bh * L + row];
    delta_r[i] = delta[(size_t)bh * L + row];
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += COLS) {
    __syncthreads();  // the last tile's K and dS are read
    stage<D>(ks, k + base + (size_t)k0 * D, COLS);
    stage<D>(vs, v + base + (size_t)k0 * D, COLS);
    if (threadIdx.x < COLS)
      kms[threadIdx.x] = kmask[(size_t)b * L + k0 + threadIdx.x];
    __syncthreads();

    float s[RPT][CPT], dp[RPT][CPT];
    products<D, CPT>(s, qs, ks, ty, tx);
    products<D, CPT>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] * scale + bias(kms[tx + TX * j], qm[i])
                             - lse_r[i]);
        dss[(ty * RPT + i) * LDS + tx + TX * j] =
            p * (dp[i][j] - delta_r[i]) * scale;
      }
    __syncthreads();
    accumulate<D, COLS>(acc, dss, ks, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float* row = dq + base + (size_t)(q0 + ty * RPT + i) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) row[tx + TX * c] = acc[i][c];
  }
}

// dK and dV: a block owns ROWS keys of one (batch*head) and walks every
// Q/dO tile (the score tiles transposed: rows are keys).
template <int D>
__device__ __forceinline__ void dkv_body(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ kmask,
    const int* __restrict__ qmask, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int L, int H,
    float scale) {
  using T = Tile<D>;
  constexpr int COLS = T::COLS, CPT = T::CPT, DPT = T::DPT, LD = T::LD,
                LDS = T::LDS;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [ROWS][LD]
  float* vs = ks + ROWS * LD;                   // [ROWS][LD]
  float* qs = vs + ROWS * LD;                   // [COLS][LD]
  float* dos = qs + COLS * LD;                  // [COLS][LD]
  float* pts = dos + COLS * LD;                 // [ROWS][LDS]
  float* dsts = pts + ROWS * LDS;               // [ROWS][LDS]
  float* lses = dsts + ROWS * LDS;              // [COLS]
  float* deltas = lses + COLS;                  // [COLS]
  int* qms = reinterpret_cast<int*>(deltas + COLS);  // [COLS]

  const int bh = blockIdx.y, b = bh / H, k0 = blockIdx.x * ROWS;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const size_t base = (size_t)bh * L * D;
  stage<D>(ks, k + base + (size_t)k0 * D, ROWS);
  stage<D>(vs, v + base + (size_t)k0 * D, ROWS);

  int km[RPT];
  float dk_acc[RPT][DPT], dv_acc[RPT][DPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    km[r] = kmask[(size_t)b * L + k0 + ty * RPT + r];
#pragma unroll
    for (int c = 0; c < DPT; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;
  }

  for (int q0 = 0; q0 < L; q0 += COLS) {
    __syncthreads();  // the last tile's Q, dO, P^T and dS^T are read
    stage<D>(qs, q + base + (size_t)q0 * D, COLS);
    stage<D>(dos, dout + base + (size_t)q0 * D, COLS);
    if (threadIdx.x < COLS) {
      const size_t row = (size_t)bh * L + q0 + threadIdx.x;
      lses[threadIdx.x] = lse[row];
      deltas[threadIdx.x] = delta[row];
      qms[threadIdx.x] = qmask[(size_t)b * L + q0 + threadIdx.x];
    }
    __syncthreads();

    float s[RPT][CPT], dp[RPT][CPT];
    products<D, CPT>(s, ks, qs, ty, tx);
    products<D, CPT>(dp, vs, dos, ty, tx);
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + TX * j;
        const float p = expf(s[r][j] * scale + bias(km[r], qms[c])
                             - lses[c]);
        pts[(ty * RPT + r) * LDS + c] = p;
        dsts[(ty * RPT + r) * LDS + c] = p * (dp[r][j] - deltas[c]) * scale;
      }
    __syncthreads();
    accumulate<D, COLS>(dv_acc, pts, dos, ty, tx);
    accumulate<D, COLS>(dk_acc, dsts, qs, ty, tx);
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const size_t row = base + (size_t)(k0 + ty * RPT + r) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      dk[row + tx + TX * c] = dk_acc[r][c];
      dv[row + tx + TX * c] = dv_acc[r][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
online_fwd_f32_kernel(const float* q, const float* k, const float* v,
                      const int* kmask, const int* qmask, float* o,
                      float* lse, int L, int H, float scale) {
  fwd_body<D>(q, k, v, kmask, qmask, o, lse, L, H, scale);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
online_bwd_dq_f32_kernel(const float* q, const float* k, const float* v,
                         const int* kmask, const int* qmask,
                         const float* dout, const float* lse,
                         const float* delta, float* dq, int L, int H,
                         float scale) {
  dq_body<D>(q, k, v, kmask, qmask, dout, lse, delta, dq, L, H, scale);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
online_bwd_dkv_f32_kernel(const float* q, const float* k, const float* v,
                          const int* kmask, const int* qmask,
                          const float* dout, const float* lse,
                          const float* delta, float* dk, float* dv, int L,
                          int H, float scale) {
  dkv_body<D>(q, k, v, kmask, qmask, dout, lse, delta, dk, dv, L, H,
              scale);
}

// A grid of L / ROWS blocks a (batch*head), and a row index that fits an
// int.
bool shape_ok(int BH, int L) {
  return L > 0 && L % 128 == 0 && BH > 0 && BH <= 65535 &&
         (long long)BH * L < (1LL << 31);
}

// Opt the kernel into `smem` bytes of dynamic shared memory, then launch
// it on a grid of L / ROWS x BH blocks; the launch's error.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, int BH, int L, cudaStream_t stream,
           Args... args) {
  if (!shape_ok(BH, L)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(L / ROWS, BH), NTHREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int D, typename Kernel>
int launch_fwd(Kernel kernel, const void* q, const void* k, const void* v,
               const void* km, const void* qm, void* o, void* lse, int BH,
               int L, int H, float scale, cudaStream_t stream) {
  return launch(kernel, Smem<D>::FWD, BH, L, stream, (const float*)q,
                (const float*)k, (const float*)v, (const int*)km,
                (const int*)qm, (float*)o, (float*)lse, L, H, scale);
}

template <int D, typename Kernel>
int launch_dq(Kernel kernel, const void* q, const void* k, const void* v,
              const void* km, const void* qm, const void* dout,
              const void* lse, const void* delta, void* dq, int BH, int L,
              int H, float scale, cudaStream_t stream) {
  return launch(kernel, Smem<D>::DQ, BH, L, stream, (const float*)q,
                (const float*)k, (const float*)v, (const int*)km,
                (const int*)qm, (const float*)dout, (const float*)lse,
                (const float*)delta, (float*)dq, L, H, scale);
}

template <int D, typename Kernel>
int launch_dkv(Kernel kernel, const void* q, const void* k, const void* v,
               const void* km, const void* qm, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int BH, int L, int H, float scale, cudaStream_t stream) {
  return launch(kernel, Smem<D>::DKV, BH, L, stream, (const float*)q,
                (const float*)k, (const float*)v, (const int*)km,
                (const int*)qm, (const float*)dout, (const float*)lse,
                (const float*)delta, (float*)dk, (float*)dv, L, H, scale);
}

}  // namespace

// Plain C interface (loaded with ctypes), the bf16 online entry points'
// arguments under an _f32 name, at D=256 alone (at D=64 and 128 they are
// attention_f32_fwd.cu's and attention_f32_bwd.cu's). Each returns the
// cudaError_t of its launches: 0 on success, cudaErrorInvalidValue at a
// head dim that is not built here. Inputs are checked by the Python
// wrapper.
extern "C" {

int lddl_online_fwd_f32(const void* q, const void* k, const void* v,
                        const void* kmask, const void* qmask, void* o,
                        void* lse, int BH, int L, int H, int D, float scale,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 256)
    return launch_fwd<256>(online_fwd_f32_kernel<256>, q, k, v, kmask,
                           qmask, o, lse, BH, L, H, scale, s);
  return (int)cudaErrorInvalidValue;
}

int lddl_online_bwd_dq_f32(const void* q, const void* k, const void* v,
                           const void* kmask, const void* qmask,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int BH, int L, int H,
                           int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 256)
    return launch_dq<256>(online_bwd_dq_f32_kernel<256>, q, k, v, kmask,
                          qmask, dout, lse, delta, dq, BH, L, H, scale, s);
  return (int)cudaErrorInvalidValue;
}

int lddl_online_bwd_dkv_f32(const void* q, const void* k, const void* v,
                            const void* kmask, const void* qmask,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int BH,
                            int L, int H, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 256)
    return launch_dkv<256>(online_bwd_dkv_f32_kernel<256>, q, k, v, kmask,
                           qmask, dout, lse, delta, dk, dv, BH, L, H, scale,
                           s);
  return (int)cudaErrorInvalidValue;
}

// The message of a cudaError_t returned by an entry point.
const char* lddl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
