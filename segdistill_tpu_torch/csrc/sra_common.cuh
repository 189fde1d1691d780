// Pieces shared by the SRA attention kernels (sra_attn.cu: K2, the forward;
// sra_attn_bwd.cu: K9, the backward): strided addressing, 16-byte
// asynchronous tile loads into shared memory, and the warp-level
// tensor-core primitives (ldmatrix, mma.sync m16n8k16 with bf16 operands
// and fp32 sums).
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row): a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                     a3 (g+8, 2t+8..)
//   B (16 x 8, col):  b0 (k 2t..2t+1, n g)  b1 (k 2t+8.., n g)
//   C (16 x 8):       c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// so the C fragments of two neighbouring n-tiles, rounded to bf16, are the
// A fragment of the next product (the probabilities never leave registers).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sra {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, h, n;
};

inline Strides strides_at(const long long* s, int i) {
  return {s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

inline bool bad_shape(int B, int heads, int N, int M, int d) {
  return B < 1 || heads < 1 || N < 1 || M < 1 || d < 8 || d > 128 || d % 8 ||
         static_cast<long long>(B) * heads > 65535;
}

// The padded head dim a kernel is instantiated for.
inline int padded_dim(int d) { return d <= 32 ? 32 : (d <= 64 ? 64 : 128); }

// Dynamic shared memory above 48 KB has to be allowed per kernel and per
// device: asked once for each, remembered in `allowed` (the caller's, one
// per kernel variant). -> the CUDA error code, so a refusal fails the launch
// loudly.
constexpr int kMaxDevices = 64;
template <typename Kernel>
inline int allow_shared_memory(Kernel kernel, int bytes,
                               bool (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[dev] = true;
  }
  return 0;
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; `bytes` = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start the copy of a (ROWS x DP) tile of T, rows `stride` elements apart
// in device memory, into shared memory with rows LD elements apart. Rows
// past `valid_rows` and columns past `d` (a multiple of 8) become zeros.
// Every address is a multiple of 16 bytes: the wrapper sees to the pointer
// and the strides.
template <typename T, int ROWS, int DP, int LD, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride, int valid_rows,
                                          int d) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = DP / VEC;
  for (int e = threadIdx.x; e < ROWS * PER_ROW; e += THREADS) {
    const int r = e / PER_ROW;
    const int c = (e % PER_ROW) * VEC;
    const bool ok = r < valid_rows && c < d;
    cp_async16(dst + r * LD + c, ok ? src + r * stride + c : src,
               ok ? 16 : 0);
  }
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8. Thread (g, t) receives of each matrix the pair (row g,
// columns 2t, 2t+1), or with .trans (rows 2t, 2t+1, column g).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16 bf16) * b (16 x 8 bf16), fp32 sums, on the tensor cores.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one instruction of the special-function unit (relative error
// 2^-22, denormal results flushed to 0; 2^-inf = 0): for the bf16 kernels,
// whose probabilities are rounded to 8 bits anyway.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared-memory addresses for ldmatrix_x4 of a tile with rows LD elements
// apart, for lane `lane`; (r0, c0) is the tile's corner.
//
// a_frag: the A fragment of rows r0..r0+15, k columns c0..c0+15 of a
//   row-major matrix (matrices: rows 0-7 / 8-15 at c0, then at c0 + 8).
// b_frag: B fragments (b0, b1) of two n-tiles from a matrix stored
//   [n][k] (keys by head dim for q k^T): n rows r0..r0+15, k columns
//   c0..c0+15; registers 0, 1 belong to n-tile r0, 2, 3 to n-tile r0 + 8.
// bt_frag (with ldmatrix_x4_trans): B fragments of two n-tiles from a
//   matrix stored [k][n] (keys by head dim for p v): k rows r0..r0+15, n
//   columns c0..c0+15; registers 0, 1 belong to n-tile c0, 2, 3 to c0 + 8.
// at_frag (with ldmatrix_x4_trans): the A fragment of the transpose of a
//   matrix stored [k][m]: k rows r0..r0+15, m columns c0..c0+15.
template <int LD>
__device__ __forceinline__ const __nv_bfloat16* a_frag(
    const __nv_bfloat16* s, int r0, int c0, int lane) {
  const int j = lane >> 3;
  return s + (r0 + (j & 1) * 8 + (lane & 7)) * LD + c0 + (j >> 1) * 8;
}
template <int LD>
__device__ __forceinline__ const __nv_bfloat16* b_frag(
    const __nv_bfloat16* s, int r0, int c0, int lane) {
  const int j = lane >> 3;
  return s + (r0 + (j >> 1) * 8 + (lane & 7)) * LD + c0 + (j & 1) * 8;
}
// transposed reads: the matrices come in the other operand's order
template <int LD>
__device__ __forceinline__ const __nv_bfloat16* bt_frag(
    const __nv_bfloat16* s, int r0, int c0, int lane) {
  return a_frag<LD>(s, r0, c0, lane);
}
template <int LD>
__device__ __forceinline__ const __nv_bfloat16* at_frag(
    const __nv_bfloat16* s, int r0, int c0, int lane) {
  return b_frag<LD>(s, r0, c0, lane);
}

}  // namespace sra
