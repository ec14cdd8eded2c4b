// Hopper (sm_90a) building blocks for the port's warp-specialised
// attention kernels (attention_fwd.cu, online_attention_bwd.cu, and
// through tf32x3_tiles.cuh attention_f32_fwd.cu and attention_f32_bwd.cu):
// mbarriers, TMA tile loads and stores (2-D tensor maps with the 128-byte
// swizzle, bf16 and fp32), bulk copies, wgmma shared-memory descriptors,
// the m64n64k16 bf16 -> fp32 wgmma in its two forms (A and B from shared
// memory; A from registers), the m64nNk8 tf32 wgmma and the tf32 split of
// the 3xTF32 products, the wgmma fence/commit/wait, setmaxnreg, named
// barriers, quad reductions, and the host-side tensor-map encoder
// (cuTensorMapEncodeTiled, looked up through the runtime so the library
// needs no -lcuda).
//
// Tile convention: an operand tile is a column panel of 64 bf16 (128
// bytes) per row, rows stored back to back, as TMA writes it with
// CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk c of row r sits at chunk
// c ^ (r % 8). Panels start on 1024-byte boundaries. A head dim of 128 is
// two panels. wgmma reads such a panel as a K-major operand (rows = M or
// N, 64 K values a row) or as an MN-major B (rows = K, 64 N values a row).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lddl_hopper {

typedef __nv_bfloat16 bf16;

constexpr int PANEL = 64;                // bf16 columns of a panel row
constexpr int ROW_BYTES = 128;           // bytes of a panel row
constexpr int GROUP_BYTES = 8 * ROW_BYTES;   // an 8-row swizzle atom

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Dynamic shared memory rounded up to the 1024-byte alignment that the
// 128-byte swizzle needs.
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// The same, by pointer arithmetic on the shared array: the compiler then
// keeps the accesses through the result in the shared space (LDS/STS),
// where align_1024's round trip through an integer leaves them generic
// (LD/ST).
__device__ __forceinline__ uint8_t* align_1024_shared(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// ---- mbarriers -----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// One arrival that also announces `bytes` of asynchronous copies.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed. Each try_wait
// suspends the thread for a while; after 2^26 of them (seconds, where a
// tile takes microseconds) a wait that can never end traps, so a fault in
// a pipeline's protocol surfaces as a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// ---- TMA and bulk copies ---------------------------------------------------

// Copy the box at (col, row) of a 2-D tensor map into shared memory;
// completion is counted on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int col, int row,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row)
      : "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// device memory into shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Store a shared-memory box to (col, row) of a 2-D tensor map.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int col,
                                             int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(col), "r"(row)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit_and_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Commit the issued stores and wait only until they have read their
// shared-memory source, which may then be overwritten (the global writes
// may still be in flight; they complete before the kernel does).
__device__ __forceinline__ void tma_store_commit_and_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's generic shared-memory writes before later reads
// by the async proxy (a TMA store).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Max and sum over the four lanes of a quad (lanes that differ in their
// low two bits), which hold one row of a wgmma accumulator.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- register budget -------------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor with the 128-byte swizzle. K-major
// operands use lbo 16 (unused) and sbo 1024 (8 rows of 128 bytes);
// MN-major B operands use sbo 1024 (8 K rows) and lbo = the bytes between
// 64-wide N panels (unused at N = 64).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// A K-major panel, starting at K column 16 * kstep (32 bytes a step).
__device__ __forceinline__ uint64_t kmajor_desc(const uint8_t* panel,
                                                int kstep) {
  return sw128_desc(panel + 32 * kstep, 16, GROUP_BYTES);
}

// An MN-major B panel, starting at K row 16 * kstep (2048 bytes a step).
__device__ __forceinline__ uint64_t mnmajor_desc(const uint8_t* panel,
                                                 int kstep) {
  return sw128_desc(panel + 16 * ROW_BYTES * kstep, 0, GROUP_BYTES);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator (or
// of an A fragment) across the asynchronous wgmma that owns it.
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define LDDL_WGMMA_D32                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define LDDL_WGMMA_OUT32(d)                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory
// (descriptors); B is K-major (TRANS_B 0) or MN-major (1). scale_d 0
// overwrites d.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LDDL_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : LDDL_WGMMA_OUT32(d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A from registers (the m64k16
// fragment: a[0] row g, a[1] row g + 8, a[2] and a[3] the same rows 8
// columns on; g = 16 * warp + lane / 4, columns 2 * (lane % 4) + {0, 1}).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LDDL_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : LDDL_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TRANS_B));
}

// ---- tf32 wgmma (tf32x3_tiles.cuh) ------------------------------------------
//
// An fp32 operand tile uses the same 128-byte swizzled panels: 32 fp32 a
// panel row (PANEL_F32), and a k8 step of tf32 is 32 bytes, as bf16's
// k16 step is, so a panel is four k steps. tf32 wgmma takes K-major
// operands only (no transpose). The values stored for it are tf32
// (cvt.rna: the low 13 bits 0), so that the tensor core reads them whole.

constexpr int PANEL_F32 = 32;            // fp32 columns of a panel row

// A K-major operand at k8 step `kstep` of a tile whose 32-column panels
// lie `panel_bytes` apart: panel kstep / 4, 32 bytes a step within it.
__device__ __forceinline__ uint64_t kmajor_desc_tf32(const uint8_t* tile,
                                                     int panel_bytes,
                                                     int kstep) {
  return sw128_desc(tile + (kstep / 4) * panel_bytes + 32 * (kstep % 4), 16,
                    GROUP_BYTES);
}

// x rounded to tf32 (10-bit mantissa, to nearest, ties away from zero).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The 3xTF32 split: hi = tf32(x), lo = tf32(x - hi) (x - hi is exact), so
// that |x - (hi + lo)| <= 2^-22 |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// The same split by integer arithmetic on the fp32 bits: cvt.rna's
// rounding for finite values (half an ulp of the 10-bit mantissa added
// to the magnitude, carrying into the exponent where it must, the low 13
// bits cleared), in five instructions where two cvt.rna and the
// subtraction take nine (cvt.rna also tests for inf and NaN). Infinities
// and NaNs stay what they are, except a NaN whose payload lies in the low
// 13 bits alone, which becomes an infinity.
__device__ __forceinline__ void split_tf32_bits(float x, uint32_t& hi,
                                                uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

template <int N>
__device__ __forceinline__ void fence_f32(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Defines r without reading it, for a register array whose next wgmma
// overwrites it (scale_d 0): the compiler then keeps no earlier value of
// it live (the wgmma's "+f" operands read it as far as the compiler
// knows).
template <int N>
__device__ __forceinline__ void undef_f32(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "=f"(r[i])::"memory");
}

template <int M>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define LDDL_D4 "{%0, %1, %2, %3}"
#define LDDL_D8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define LDDL_D16                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define LDDL_D32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define LDDL_OUT4(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
#define LDDL_OUT8(d)                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7])
#define LDDL_OUT16(d)                                                        \
  LDDL_OUT8(d), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),            \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define LDDL_OUT32(d)                                                        \
  LDDL_OUT16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),         \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
      "+f"(d[30]), "+f"(d[31])

// d[64 x N] (+)= A[64 x 8] B[8 x N] in tf32 with fp32 accumulation, A and
// B K-major from shared memory (descriptors); scale_d 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[N / 2], uint64_t da,
                                              uint64_t db, int scale_d);

// d[64 x N] (+)= A[64 x 8] B[8 x N], A from registers: the m64k8 tf32
// fragment, a[0] (row g, column t), a[1] (g + 8, t), a[2] (g, t + 4),
// a[3] (g + 8, t + 4); g = 16 * warp + lane / 4, t = lane % 4.
template <int N>
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d);

#define LDDL_TF32_SS(N, DREGS, OUTS, IA, IB, IS)                             \
  template <>                                                                \
  __device__ __forceinline__ void wgmma_ss_tf32<N>(                          \
      float(&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {             \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"           \
                 "wgmma.mma_async.sync.aligned.m64n" #N                      \
                 "k8.f32.tf32.tf32 " DREGS ", %" #IA ", %" #IB               \
                 ", p, 1, 1;\n}\n"                                           \
                 : OUTS(d)                                                   \
                 : "l"(da), "l"(db), "r"(scale_d));                          \
  }
LDDL_TF32_SS(16, LDDL_D8, LDDL_OUT8, 8, 9, 10)
LDDL_TF32_SS(32, LDDL_D16, LDDL_OUT16, 16, 17, 18)
LDDL_TF32_SS(64, LDDL_D32, LDDL_OUT32, 32, 33, 34)
#undef LDDL_TF32_SS

template <>
__device__ __forceinline__ void wgmma_rs_tf32<8>(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 " LDDL_D4
      ", {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : LDDL_OUT4(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_tf32<16>(float (&d)[8],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 " LDDL_D8
      ", {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : LDDL_OUT8(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_tf32<32>(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " LDDL_D16
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : LDDL_OUT16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_tf32<64>(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " LDDL_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : LDDL_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef LDDL_D4
#undef LDDL_OUT4
#undef LDDL_D8
#undef LDDL_D16
#undef LDDL_D32
#undef LDDL_OUT8
#undef LDDL_OUT16
#undef LDDL_OUT32

#undef LDDL_WGMMA_D32
#undef LDDL_WGMMA_OUT32

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The m64n64 fp32 accumulator as four bf16 A fragments (k = 16 columns
// each): accumulator element 4j + e holds row g + 8 (e / 2), column
// 8j + 2 (lane % 4) + e % 2, which is the A fragment's layout.
__device__ __forceinline__ void acc_to_a(const float (&acc)[32],
                                         uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(acc[8 * kk + 2 * i], acc[8 * kk + 2 * i + 1]);
}

// Write a warpgroup's m64n64 fp32 accumulator as bf16 into a 128-byte
// swizzled panel of 64 rows (the layout a TMA store with
// CU_TENSOR_MAP_SWIZZLE_128B reads). wtid is the thread's index in its
// warpgroup.
__device__ __forceinline__ void acc_to_panel(const float (&acc)[32],
                                             uint8_t* panel, int wtid) {
  const int warp = wtid / 32, lane = wtid % 32;
  const int r0 = 16 * warp + lane / 4;
  const int cb = 4 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int chunk = (j ^ (r0 % 8)) * 16;   // rows r0 and r0 + 8 alike
    *reinterpret_cast<uint32_t*>(panel + r0 * ROW_BYTES + chunk + cb) =
        pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(panel + (r0 + 8) * ROW_BYTES + chunk + cb) =
        pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ---- host ------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline cudaError_t encode_fn(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// Tensor map over a row-major [rows, cols] bf16 matrix, boxes of 64 rows
// x 64 columns with the 128-byte swizzle.
inline cudaError_t make_map(CUtensorMap* map, const void* base,
                            uint64_t rows, uint64_t cols) {
  EncodeTiledFn encode;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(bf16)};
  const cuuint32_t box[2] = {PANEL, 64};
  const cuuint32_t elem[2] = {1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                      const_cast<void*>(base), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Tensor map over a row-major [rows, cols] fp32 matrix, boxes of
// `box_rows` rows x 32 columns (128 bytes) with the 128-byte swizzle.
inline cudaError_t make_map_f32(CUtensorMap* map, const void* base,
                                uint64_t rows, uint64_t cols, int box_rows) {
  EncodeTiledFn encode;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(float)};
  const cuuint32_t box[2] = {PANEL_F32, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                      const_cast<void*>(base), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Tensor maps over the [BH * L, D] views of `n` operands.
inline cudaError_t make_maps(CUtensorMap* maps, const void* const* ptrs,
                             int n, int BH, int L, int D) {
  for (int i = 0; i < n; ++i) {
    cudaError_t err = make_map(&maps[i], ptrs[i], (uint64_t)BH * L, D);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Lengths a grid of blocks of `rows` rows covers, and a 2-D row index
// that fits an int.
inline bool shape_ok(int BH, int L, int rows) {
  return L > 0 && L % rows == 0 && BH > 0 && BH <= 65535 &&
         (long long)BH * L < (1LL << 31);
}

}  // namespace lddl_hopper

// The message of a cudaError_t returned by a C entry point (ctypes).
extern "C" const char* lddl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
