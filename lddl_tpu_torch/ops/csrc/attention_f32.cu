// fp32 attention for Hopper (sm_90a) in SIMT fp32 FFMA, at D=256: the
// fp32 build of the online forward of lddl_tpu/ops/flash_attention.py at
// the one width whose 3xTF32 build is not written yet, beside the bf16
// kernels of attention_fwd.cu. At D=64 and 128 the fp32 forwards run on
// the tensor cores in 3xTF32 (attention_f32_fwd.cu), and the fp32
// backward at every width (attention_f32_bwd.cu: the online pair at D=256
// on its wide bodies). One kernel body, instantiated under the bf16 set's
// online name with an _f32 suffix, so that the profiler tells them apart,
// with the C entry point of the bf16 set's kernel call:
//
//   online_fwd_f32_kernel      replaces _fwd_kernel       (lddl_online_fwd_f32, D=256)
//
// What it computes: the bf16 kernel's function (attention_fwd.cu says it
// in full) on fp32 operands, where the reference's cast of P to V's dtype
// is a no-op:
//   S  = Q K^T * scale + bias, bias = 0 where kmask > 0 && kmask == qmask,
//        else -1e9 (fp32, added to the scaled score; never -inf);
//   walk the K/V tiles with a running max m, denominator l and an fp32
//   accumulator, each rescaled by exp(m - m_new);
//   O = acc / max(l, 1e-30), LSE = m + log(max(l, 1e-30)).
// expf and logf, not the fast-math intrinsics. No tile is skipped: padded
// query rows (qmask 0) see every key disallowed and spread over all L_pad
// keys, as in the reference. No atomics: every output element is written
// by one thread of one block, which sums in a fixed order, so two
// launches give bit-identical results.
// Layout: q/k/v/o [B*H, L_pad, D] fp32, masks int32 [B, L_pad], LSE fp32
// [B*H, L_pad]. L_pad is a multiple of 128; D is 256 (template; the
// wrapper zero-pads any head dim between 129 and 255 up to it).
//
// What bounds it on this card: every product is an fp32 FFMA on the
// CUDA cores, 66.9 TFLOP/s. At phase 16's shape (B=8, H=3, L_pad 1024,
// D=256) the forward does 25.8 GFLOP against 101 MB of operands: 0.39 ms
// of FFMA against 0.03 ms of bytes; the CUDA cores bound it.
//
// Design (SIMT, a simple kernel first): a block of 256 threads, a 16 x 16
// grid, owns ROWS = 64 query rows of one (batch*head). It stages its own
// rows in shared memory once and walks the K/V tiles of COLS = 32 rows,
// so that two staged fp32 tiles of 256 columns fit beside the block's own
// rows. Staged rows are padded to D + 1 floats, so that the 16 threads of
// a row group, reading 16 rows at one column, hit 16 banks. Each thread
// owns a 4 x (COLS/16) patch of every score tile (rows ty*4 + i, columns
// tx + 16 j): its products run down D in order, and a row's max and sum
// are finished by shuffles over the 16 threads of a half-warp. P then
// passes through shared memory to P V, where a thread owns a 4 x (D/16)
// patch of the block's output rows (columns tx + 16 c) in registers.

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

// Shared memory of the body, in bytes.
template <int D>
struct Smem {
  using T = Tile<D>;
  static constexpr size_t FWD =
      sizeof(float) * ((ROWS + 2 * T::COLS) * T::LD + ROWS * T::LDS) +
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

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
online_fwd_f32_kernel(const float* q, const float* k, const float* v,
                      const int* kmask, const int* qmask, float* o,
                      float* lse, int L, int H, float scale) {
  fwd_body<D>(q, k, v, kmask, qmask, o, lse, L, H, scale);
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

}  // namespace

// Plain C interface (loaded with ctypes), the bf16 online forward entry
// point's arguments under an _f32 name, at D=256 alone (at D=64 and 128
// it is attention_f32_fwd.cu's). It returns the cudaError_t of its
// launch: 0 on success, cudaErrorInvalidValue at a head dim that is not
// built here. Inputs are checked by the Python wrapper.
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

// The message of a cudaError_t returned by an entry point.
const char* lddl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
