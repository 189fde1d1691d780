// K9: backward of MiT spatial-reduction attention for Hopper (sm_90a).
//
// Replaces the backward of
// segdistill_tpu/ops/pallas/sra_attn.py::sra_attention_train (the
// pallas_call at sra_attn.py:182); its forward is K2 (sra_attn.cu), which
// keeps each row's log-sum-exp and the fp32 output. The flash-attention
// backward with the JAX kernel's math, P recomputed from q, k and the saved
// log-sum-exp:
//
//   P = exp(s q k^T - lse),  D = rowsum(dO o O),  dS = P o (dO v^T - D) s
//   dq = dS k,  dk = dS^T q,  dv = P^T dO
//
// What bounds it on this card: operations, 10*N*M*d in five products plus
// N*M exponentials, against q, dO, O and dq read or written once. One fused
// pass computes S and dP once per (query tile, key block), where three
// launches used to compute them twice; a second small kernel sums partials.
//
// The fused pass. A block owns one split of a head's query rows and one
// chunk of at most KS keys, whose K and V stay in shared memory for the
// block's life together with the chunk's fp32 dk and dv sums. It walks its
// rows in tiles of 64. Per tile: Q and dO into shared memory, D from the
// fp32 output in the tile's prologue; then per block of 64 keys, phase A
// with the threads on query rows: S, dP, P = exp2(S c - lse), dS, and
// dq += dS K in registers; P and dS go to shared memory once; phase B with
// the threads on key rows: dv += P^T dO and dk += dS^T Q for the block's
// keys, added into the shared sums (every element has one owner: no
// atomics). A query row belongs to one block, which writes its dq directly.
// At the end the block writes one fp32 partial dk, dv per split; the
// second kernel sums them in split order. Everything is summed in a fixed
// order: the gradients are the same bits on every run.
//
// Heads with more than KS keys (KS = 256 at d <= 32, 128 at d <= 64, 64 at
// d <= 128 for bf16; 256, 128, 32 for fp32) are cut into key chunks on the
// grid: each chunk's block then writes an fp32 partial dq, and the second
// kernel sums those in chunk order too.
//
// bf16 inputs: the five products run on the tensor cores
// (mma.sync.m16n8k16, bf16 operands, fp32 sums; wgmma was not taken, see
// sra_attn.cu). 4 warps; in phase A a warp owns 16 query rows and P and dS
// are already the A operands of dS K in the accumulator layout; the
// transposed products of phase B read P and dS (bf16, stored once) and dO
// and Q from shared memory with ldmatrix.trans, a warp owning 16 keys. P
// and dS are rounded to bf16, as the JAX kernel rounds them.
//
// fp32 inputs: full fp32 on CUDA cores with the same two phases (no TF32:
// the fp32 train step is held against the CPU). 256 threads; phase A as
// K2's fp32 kernel (4 lanes per query row splitting the head dim and the
// keys, four key dots in flight, float4 reads), phase B one key and a
// slice of the head dim per thread.
//
// Strides as in sra_attn.cu. Plain C interface, loaded with ctypes; returns
// the CUDA error code.

#include "sra_common.cuh"

namespace {

using namespace sra;

constexpr int kTile = 64;  // query rows per tile

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* o;
  const void* g;
  const float* lse;
  float* part_dk;
  float* part_dv;
  float* dq_part;
  void* dq;
  void* dk;
  void* dv;
  int B, heads, N, M, d, splits, rows_per_split, key_chunks;
  Strides qs, ks, vs, os, gs, dqs, dks, dvs;
  float scale;
};

// ---------------------------------------------------------------- bf16
constexpr int kMmaThreads = 128;

template <int DP>
struct MmaPlan {
  static constexpr int KS = 8192 / DP;  // keys resident per block
  static constexpr int LD = DP + 8;     // bf16 rows of K, V, Q, dO
  static constexpr int LP = 64 + 8;     // bf16 rows of P, dS
  static constexpr int LA = DP + 8;     // fp32 rows of the dk, dv sums
  static constexpr int smem = 2 * KS * LD * 2 + 2 * kTile * LD * 2 +
                              2 * kTile * LP * 2 + 2 * KS * LA * 4 +
                              2 * kTile * 4;
};

// acc (16 keys x DP) = A^T B over the tile's 64 query rows, A = P or dS
// (stored [query][key]), B = dO or Q (stored [query][dim]); added into the
// shared fp32 sums of keys key0 .. key0 + 15.
template <int DP>
__device__ __forceinline__ void transposed_product(
    const __nv_bfloat16* a_s, const __nv_bfloat16* b_s, float* sum_s,
    int warp, int lane, int key0) {
  using P = MmaPlan<DP>;
  float acc[DP / 8][4];
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  }
#pragma unroll
  for (int qk = 0; qk < kTile / 16; ++qk) {
    uint32_t af[4];
    ldmatrix_x4_trans(af, at_frag<P::LP>(a_s, qk * 16, warp * 16, lane));
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, bt_frag<P::LD>(b_s, qk * 16, dp * 16, lane));
      mma_bf16(acc[2 * dp], af, bf[0], bf[1]);
      mma_bf16(acc[2 * dp + 1], af, bf[2], bf[3]);
    }
  }
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt) {
    float2* a = reinterpret_cast<float2*>(sum_s + (key0 + g) * P::LA +
                                          nt * 8 + 2 * t);
    float2* b = reinterpret_cast<float2*>(sum_s + (key0 + g + 8) * P::LA +
                                          nt * 8 + 2 * t);
    float2 x = *a, y = *b;
    x.x += acc[nt][0];
    x.y += acc[nt][1];
    y.x += acc[nt][2];
    y.y += acc[nt][3];
    *a = x;
    *b = y;
  }
}

// One block an SM (its shared memory allows no more): said to the compiler,
// which then keeps everything in registers (no spill at any head dim).
template <int DP>
__global__ void __launch_bounds__(kMmaThreads, 1)
    sra_bwd_mma(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const float* __restrict__ o,
                const __nv_bfloat16* __restrict__ gr,
                const float* __restrict__ lse, float* __restrict__ part_dk,
                float* __restrict__ part_dv, float* __restrict__ dq_part,
                __nv_bfloat16* __restrict__ dq, int heads, int N, int M,
                int d, int rows_per_split, Strides qs, Strides ks, Strides vs,
                Strides os, Strides gs, Strides dqs, float scale) {
  using P = MmaPlan<DP>;
  constexpr int KS = P::KS, LD = P::LD, LP = P::LP, LA = P::LA;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + KS * LD;
  __nv_bfloat16* q_s = v_s + KS * LD;
  __nv_bfloat16* g_s = q_s + kTile * LD;
  __nv_bfloat16* p_s = g_s + kTile * LD;
  __nv_bfloat16* ds_s = p_s + kTile * LP;
  float* dk_s = reinterpret_cast<float*>(ds_s + kTile * LP);
  float* dv_s = dk_s + KS * LA;
  float* lse_s = dv_s + KS * LA;  // base-2 log-sum-exp of the tile's rows
  float* dsum_s = lse_s + kTile;  // D of the tile's rows

  const int bh = blockIdx.z;
  const int b = bh / heads;
  const int hh = bh % heads;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float scale_log2 = scale * kLog2e;

  const int c0 = blockIdx.y * KS;  // this block's key chunk
  const int kc = min(KS, M - c0);
  const __nv_bfloat16* q_head = q + b * qs.b + hh * qs.h;
  const __nv_bfloat16* g_head = gr + b * gs.b + hh * gs.h;
  const float* o_head = o + b * os.b + hh * os.h;
  load_tile<__nv_bfloat16, KS, DP, LD, kMmaThreads>(
      k_s, k + b * ks.b + hh * ks.h + c0 * ks.n, ks.n, kc, d);
  load_tile<__nv_bfloat16, KS, DP, LD, kMmaThreads>(
      v_s, v + b * vs.b + hh * vs.h + c0 * vs.n, vs.n, kc, d);
  for (int e = threadIdx.x; e < 2 * KS * LA; e += kMmaThreads) {
    dk_s[e] = 0.0f;  // dk_s and dv_s are neighbours
  }

  const int n0 = blockIdx.x * rows_per_split;
  const int n1 = min(N, n0 + rows_per_split);
  for (int r0 = n0; r0 < n1; r0 += kTile) {
    const int rc = min(kTile, n1 - r0);
    __syncthreads();  // the previous tile has been consumed
    load_tile<__nv_bfloat16, kTile, DP, LD, kMmaThreads>(
        q_s, q_head + r0 * qs.n, qs.n, rc, d);
    load_tile<__nv_bfloat16, kTile, DP, LD, kMmaThreads>(
        g_s, g_head + r0 * gs.n, gs.n, rc, d);
    {  // D = rowsum(dO o O) and the log-sum-exp: two threads per row
      const int row = threadIdx.x >> 1;
      const int half = threadIdx.x & 1;
      float acc = 0.0f;
      if (row < rc) {
        const float* o_row = o_head + (r0 + row) * os.n;
        const __nv_bfloat16* g_row = g_head + (r0 + row) * gs.n;
        for (int c = half * 4; c < d; c += 8) {
          const float4 ov = *reinterpret_cast<const float4*>(o_row + c);
          const uint2 gv = *reinterpret_cast<const uint2*>(g_row + c);
          const float2 g01 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&gv.x));
          const float2 g23 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&gv.y));
          acc = fmaf(ov.x, g01.x, acc);
          acc = fmaf(ov.y, g01.y, acc);
          acc = fmaf(ov.z, g23.x, acc);
          acc = fmaf(ov.w, g23.y, acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (half == 0) {
        dsum_s[row] = acc;
        // rows past the split's end: P = exp2(-inf) = 0
        lse_s[row] = row < rc
                         ? lse[static_cast<long long>(bh) * N + r0 + row] *
                               kLog2e
                         : INFINITY;
      }
    }
    cp_async_wait_all();
    __syncthreads();

    const int row_a = warp * 16 + g;  // in the tile; the other is + 8
    const float lse_a = -lse_s[row_a], lse_b = -lse_s[row_a + 8];  // -lse
    const float d_a = dsum_s[row_a], d_b = dsum_s[row_a + 8];
    float dq_acc[DP / 8][4];
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      dq_acc[nt][0] = dq_acc[nt][1] = dq_acc[nt][2] = dq_acc[nt][3] = 0.0f;
    }

    for (int k0 = 0; k0 < kc; k0 += 64) {
      // phase A: this warp's 16 query rows against 64 keys
      float s[8][4], dp[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t qf[4], gf[4];
        ldmatrix_x4(qf, a_frag<LD>(q_s, warp * 16, kk * 16, lane));
        ldmatrix_x4(gf, a_frag<LD>(g_s, warp * 16, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bf[4];
          ldmatrix_x4(bf, b_frag<LD>(k_s, k0 + np * 16, kk * 16, lane));
          mma_bf16(s[2 * np], qf, bf[0], bf[1]);
          mma_bf16(s[2 * np + 1], qf, bf[2], bf[3]);
          ldmatrix_x4(bf, b_frag<LD>(v_s, k0 + np * 16, kk * 16, lane));
          mma_bf16(dp[2 * np], gf, bf[0], bf[1]);
          mma_bf16(dp[2 * np + 1], gf, bf[2], bf[3]);
        }
      }
      const bool ragged = k0 + 64 > kc;  // only the last keys need a mask
      uint32_t dsf[4][4];  // dS as A fragments, 16 keys each
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l = (e >> 1) ? lse_b : lse_a;
          const float dd = (e >> 1) ? d_b : d_a;
          p[e] = fast_exp2(fmaf(s[nt][e], scale_log2, l));
          if (ragged && k0 + nt * 8 + 2 * t + (e & 1) >= kc) p[e] = 0.0f;
          ds[e] = p[e] * (dp[nt][e] - dd) * scale;
        }
        const uint32_t p01 = pack_bf16(p[0], p[1]);
        const uint32_t p23 = pack_bf16(p[2], p[3]);
        const uint32_t ds01 = pack_bf16(ds[0], ds[1]);
        const uint32_t ds23 = pack_bf16(ds[2], ds[3]);
        const int col = nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(p_s + row_a * LP + col) = p01;
        *reinterpret_cast<uint32_t*>(p_s + (row_a + 8) * LP + col) = p23;
        *reinterpret_cast<uint32_t*>(ds_s + row_a * LP + col) = ds01;
        *reinterpret_cast<uint32_t*>(ds_s + (row_a + 8) * LP + col) = ds23;
        dsf[nt >> 1][(nt & 1) * 2] = ds01;
        dsf[nt >> 1][(nt & 1) * 2 + 1] = ds23;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // dq += dS K
#pragma unroll
        for (int dd = 0; dd < DP / 16; ++dd) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf,
                            bt_frag<LD>(k_s, k0 + kk * 16, dd * 16, lane));
          mma_bf16(dq_acc[2 * dd], dsf[kk], bf[0], bf[1]);
          mma_bf16(dq_acc[2 * dd + 1], dsf[kk], bf[2], bf[3]);
        }
      }
      __syncthreads();  // P and dS of all 64 rows are in shared memory
      // phase B: this warp's 16 keys against the tile's 64 query rows
      transposed_product<DP>(p_s, g_s, dv_s, warp, lane, k0 + warp * 16);
      transposed_product<DP>(ds_s, q_s, dk_s, warp, lane, k0 + warp * 16);
      __syncthreads();  // before P and dS are overwritten
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + row_a + 8 * half;
      if (row >= n1) continue;
#pragma unroll
      for (int nt = 0; nt < DP / 8; ++nt) {
        const int col = nt * 8 + 2 * t;
        if (col >= d) continue;
        const float x = dq_acc[nt][2 * half], y = dq_acc[nt][2 * half + 1];
        if (dq_part != nullptr) {
          *reinterpret_cast<float2*>(
              dq_part +
              ((static_cast<long long>(blockIdx.y) * gridDim.z + bh) * N +
               row) * d + col) = make_float2(x, y);
        } else {
          *reinterpret_cast<uint32_t*>(dq + b * dqs.b + hh * dqs.h +
                                       row * dqs.n + col) = pack_bf16(x, y);
        }
      }
    }
  }

  cp_async_wait_all();  // a split without rows still waits for K and V
  __syncthreads();
  const long long part0 =
      ((static_cast<long long>(blockIdx.x) * gridDim.z + bh) * M + c0) * d;
  for (int e = threadIdx.x; e < KS * (DP / 4); e += kMmaThreads) {
    const int key = e / (DP / 4);
    const int c = (e % (DP / 4)) * 4;
    if (key < kc && c < d) {
      *reinterpret_cast<float4*>(part_dk + part0 + key * d + c) =
          *reinterpret_cast<const float4*>(dk_s + key * LA + c);
      *reinterpret_cast<float4*>(part_dv + part0 + key * d + c) =
          *reinterpret_cast<const float4*>(dv_s + key * LA + c);
    }
  }
}

// ---------------------------------------------------------------- fp32
constexpr int kF32Threads = 256;  // phase A: 64 query rows x 4 lanes

template <int DP>
struct F32Plan {
  static constexpr int SB = DP <= 64 ? 64 : 32;     // keys per block
  static constexpr int KS = DP <= 64 ? 8192 / DP : 32;  // resident keys
  static constexpr int DL = DP / 32;      // lanes that split the head dim
  static constexpr int KL = 4 / DL;       // lanes that split the keys
  static constexpr int LD = DP + 4 * DL;  // rows of K, V, Q, dO
  static constexpr int LP = SB + 1;       // rows of P, dS
  static constexpr int LA = DP + 4;       // rows of the dk, dv sums
  static constexpr int W = DP * SB / kF32Threads;  // dims a thread owns (B)
  static constexpr int smem = 4 * (2 * KS * LD + 2 * kTile * LD +
                                   2 * kTile * LP + 2 * KS * LA);
};

template <int DP>
__global__ void __launch_bounds__(kF32Threads)
    sra_bwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ o,
                const float* __restrict__ gr, const float* __restrict__ lse,
                float* __restrict__ part_dk, float* __restrict__ part_dv,
                float* __restrict__ dq_part, float* __restrict__ dq,
                int heads, int N, int M, int d, int rows_per_split,
                Strides qs, Strides ks, Strides vs, Strides os, Strides gs,
                Strides dqs, float scale) {
  using P = F32Plan<DP>;
  constexpr int KS = P::KS, SB = P::SB, DL = P::DL, KL = P::KL, LD = P::LD,
                LP = P::LP, LA = P::LA, W = P::W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);
  float* v_s = k_s + KS * LD;
  float* q_s = v_s + KS * LD;
  float* g_s = q_s + kTile * LD;
  float* dk_s = g_s + kTile * LD;
  float* dv_s = dk_s + KS * LA;
  float* p_s = dv_s + KS * LA;
  float* ds_s = p_s + kTile * LP;

  const int bh = blockIdx.z;
  const int b = bh / heads;
  const int hh = bh % heads;
  const float scale_log2 = scale * kLog2e;
  // phase A: a query row and a (dim slice, key slice) of it
  const int row_t = threadIdx.x >> 2;
  const int l4 = threadIdx.x & 3;
  const int dl = l4 % DL;
  const int kl = l4 / DL;
  // phase B: a key of the block and W dims of it
  const int key_t = threadIdx.x % SB;
  const int col_t = (threadIdx.x / SB) * W;

  const int c0 = blockIdx.y * KS;
  const int kc = min(KS, M - c0);
  const float* q_head = q + b * qs.b + hh * qs.h;
  const float* g_head = gr + b * gs.b + hh * gs.h;
  const float* o_head = o + b * os.b + hh * os.h;
  load_tile<float, KS, DP, LD, kF32Threads>(
      k_s, k + b * ks.b + hh * ks.h + c0 * ks.n, ks.n, kc, d);
  load_tile<float, KS, DP, LD, kF32Threads>(
      v_s, v + b * vs.b + hh * vs.h + c0 * vs.n, vs.n, kc, d);
  for (int e = threadIdx.x; e < 2 * KS * LA; e += kF32Threads) {
    dk_s[e] = 0.0f;  // dk_s and dv_s are neighbours
  }

  const int n0 = blockIdx.x * rows_per_split;
  const int n1 = min(N, n0 + rows_per_split);
  for (int r0 = n0; r0 < n1; r0 += kTile) {
    const int rc = min(kTile, n1 - r0);
    __syncthreads();  // the previous tile has been consumed
    load_tile<float, kTile, DP, LD, kF32Threads>(q_s, q_head + r0 * qs.n,
                                                 qs.n, rc, d);
    load_tile<float, kTile, DP, LD, kF32Threads>(g_s, g_head + r0 * gs.n,
                                                 gs.n, rc, d);
    cp_async_wait_all();
    __syncthreads();

    const bool active = row_t < rc;
    float q_r[32], g_r[32], dq_acc[32];
    float dsum = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = (c * DL + dl) * 4;
      const float4 qv = *reinterpret_cast<const float4*>(
          q_s + row_t * LD + col);
      const float4 gv = *reinterpret_cast<const float4*>(
          g_s + row_t * LD + col);
      float4 ov = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (active && col < d) {
        ov = *reinterpret_cast<const float4*>(o_head + (r0 + row_t) * os.n +
                                              col);
      }
      q_r[4 * c] = qv.x, q_r[4 * c + 1] = qv.y;
      q_r[4 * c + 2] = qv.z, q_r[4 * c + 3] = qv.w;
      g_r[4 * c] = gv.x, g_r[4 * c + 1] = gv.y;
      g_r[4 * c + 2] = gv.z, g_r[4 * c + 3] = gv.w;
      dsum = fmaf(gv.x, ov.x, dsum);
      dsum = fmaf(gv.y, ov.y, dsum);
      dsum = fmaf(gv.z, ov.z, dsum);
      dsum = fmaf(gv.w, ov.w, dsum);
      dq_acc[4 * c] = dq_acc[4 * c + 1] = 0.0f;
      dq_acc[4 * c + 2] = dq_acc[4 * c + 3] = 0.0f;
    }
#pragma unroll
    for (int mask = 1; mask < DL; mask <<= 1) {
      dsum += __shfl_xor_sync(0xffffffffu, dsum, mask);
    }
    // rows past the split's end: P = exp2(-inf) = 0
    const float lse2 =
        active ? lse[static_cast<long long>(bh) * N + r0 + row_t] * kLog2e
               : INFINITY;

    for (int k0 = 0; k0 < kc; k0 += SB) {
      // phase A: four keys in flight per thread
#pragma unroll 1
      for (int j0 = 0; j0 < SB / KL; j0 += 4) {
        float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int c = 0; c < 8; ++c) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int off =
                (k0 + (j0 + u) * KL + kl) * LD + (c * DL + dl) * 4;
            const float4 kv = *reinterpret_cast<const float4*>(k_s + off);
            const float4 vv = *reinterpret_cast<const float4*>(v_s + off);
            s[u] = fmaf(q_r[4 * c], kv.x, s[u]);
            s[u] = fmaf(q_r[4 * c + 1], kv.y, s[u]);
            s[u] = fmaf(q_r[4 * c + 2], kv.z, s[u]);
            s[u] = fmaf(q_r[4 * c + 3], kv.w, s[u]);
            dp[u] = fmaf(g_r[4 * c], vv.x, dp[u]);
            dp[u] = fmaf(g_r[4 * c + 1], vv.y, dp[u]);
            dp[u] = fmaf(g_r[4 * c + 2], vv.z, dp[u]);
            dp[u] = fmaf(g_r[4 * c + 3], vv.w, dp[u]);
          }
        }
        float ds[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int mask = 1; mask < DL; mask <<= 1) {
            s[u] += __shfl_xor_sync(0xffffffffu, s[u], mask);
            dp[u] += __shfl_xor_sync(0xffffffffu, dp[u], mask);
          }
          const int key = (j0 + u) * KL + kl;  // in the block of SB keys
          const float p =
              k0 + key < kc ? exp2f(s[u] * scale_log2 - lse2) : 0.0f;
          ds[u] = p * (dp[u] - dsum) * scale;
          if (dl == 0) {
            p_s[row_t * LP + key] = p;
            ds_s[row_t * LP + key] = ds[u];
          }
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) {  // dq += dS K
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 kv = *reinterpret_cast<const float4*>(
                k_s + (k0 + (j0 + u) * KL + kl) * LD + (c * DL + dl) * 4);
            dq_acc[4 * c] = fmaf(ds[u], kv.x, dq_acc[4 * c]);
            dq_acc[4 * c + 1] = fmaf(ds[u], kv.y, dq_acc[4 * c + 1]);
            dq_acc[4 * c + 2] = fmaf(ds[u], kv.z, dq_acc[4 * c + 2]);
            dq_acc[4 * c + 3] = fmaf(ds[u], kv.w, dq_acc[4 * c + 3]);
          }
        }
      }
      __syncthreads();  // P and dS of all 64 rows are in shared memory
      // phase B: key key_t of the block, dims col_t .. col_t + W - 1
      float dk_r[W], dv_r[W];
#pragma unroll
      for (int i = 0; i < W; ++i) dk_r[i] = dv_r[i] = 0.0f;
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        const float p = p_s[r * LP + key_t];
        const float ds = ds_s[r * LP + key_t];
#pragma unroll
        for (int i = 0; i < W; i += 4) {
          const float4 gv = *reinterpret_cast<const float4*>(
              g_s + r * LD + col_t + i);
          const float4 qv = *reinterpret_cast<const float4*>(
              q_s + r * LD + col_t + i);
          dv_r[i] = fmaf(p, gv.x, dv_r[i]);
          dv_r[i + 1] = fmaf(p, gv.y, dv_r[i + 1]);
          dv_r[i + 2] = fmaf(p, gv.z, dv_r[i + 2]);
          dv_r[i + 3] = fmaf(p, gv.w, dv_r[i + 3]);
          dk_r[i] = fmaf(ds, qv.x, dk_r[i]);
          dk_r[i + 1] = fmaf(ds, qv.y, dk_r[i + 1]);
          dk_r[i + 2] = fmaf(ds, qv.z, dk_r[i + 2]);
          dk_r[i + 3] = fmaf(ds, qv.w, dk_r[i + 3]);
        }
      }
#pragma unroll
      for (int i = 0; i < W; i += 4) {
        float4* a = reinterpret_cast<float4*>(dk_s + (k0 + key_t) * LA +
                                              col_t + i);
        float4* c = reinterpret_cast<float4*>(dv_s + (k0 + key_t) * LA +
                                              col_t + i);
        float4 x = *a, y = *c;
        x.x += dk_r[i], x.y += dk_r[i + 1];
        x.z += dk_r[i + 2], x.w += dk_r[i + 3];
        y.x += dv_r[i], y.y += dv_r[i + 1];
        y.z += dv_r[i + 2], y.w += dv_r[i + 3];
        *a = x;
        *c = y;
      }
      __syncthreads();  // before P and dS are overwritten
    }

    // the key lanes of a row add their dq shares, in a fixed order
#pragma unroll
    for (int mask = DL; mask < 4; mask <<= 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        dq_acc[i] += __shfl_xor_sync(0xffffffffu, dq_acc[i], mask);
      }
    }
    if (active && kl == 0) {
      const int row = r0 + row_t;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = (c * DL + dl) * 4;
        if (col >= d) continue;
        const float4 x = make_float4(dq_acc[4 * c], dq_acc[4 * c + 1],
                                     dq_acc[4 * c + 2], dq_acc[4 * c + 3]);
        if (dq_part != nullptr) {
          *reinterpret_cast<float4*>(
              dq_part +
              ((static_cast<long long>(blockIdx.y) * gridDim.z + bh) * N +
               row) * d + col) = x;
        } else {
          *reinterpret_cast<float4*>(dq + b * dqs.b + hh * dqs.h +
                                     row * dqs.n + col) = x;
        }
      }
    }
  }

  cp_async_wait_all();  // a split without rows still waits for K and V
  __syncthreads();
  const long long part0 =
      ((static_cast<long long>(blockIdx.x) * gridDim.z + bh) * M + c0) * d;
  for (int e = threadIdx.x; e < KS * (DP / 4); e += kF32Threads) {
    const int key = e / (DP / 4);
    const int c = (e % (DP / 4)) * 4;
    if (key < kc && c < d) {
      *reinterpret_cast<float4*>(part_dk + part0 + key * d + c) =
          *reinterpret_cast<const float4*>(dk_s + key * LA + c);
      *reinterpret_cast<float4*>(part_dv + part0 + key * d + c) =
          *reinterpret_cast<const float4*>(dv_s + key * LA + c);
    }
  }
}

// dk, dv = the sums of the partials over the splits, in split order, and,
// where the keys were cut into chunks, dq = the sum of its partials in
// chunk order; one element per thread.
template <typename T>
__global__ void __launch_bounds__(256)
    sra_bwd_reduce(const float* __restrict__ part_dk,
                   const float* __restrict__ part_dv, int splits, int heads,
                   int M, int d, long long n_kv, T* __restrict__ dk,
                   T* __restrict__ dv, Strides dks, Strides dvs,
                   const float* __restrict__ dq_part, int key_chunks, int N,
                   long long n_q, T* __restrict__ dq, Strides dqs) {
  long long e = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (e < n_kv) {
    float sk = 0.0f, sv = 0.0f;
    for (int s = 0; s < splits; ++s) {
      sk += part_dk[s * n_kv + e];
      sv += part_dv[s * n_kv + e];
    }
    const int i = static_cast<int>(e % d);
    const long long rest = e / d;
    const int m = static_cast<int>(rest % M);
    const int bh = static_cast<int>(rest / M);
    const int b = bh / heads;
    const int hh = bh % heads;
    dk[b * dks.b + hh * dks.h + m * dks.n + i] = from_f32<T>(sk);
    dv[b * dvs.b + hh * dvs.h + m * dvs.n + i] = from_f32<T>(sv);
    return;
  }
  e -= n_kv;
  if (e >= n_q) return;
  float sq = 0.0f;
  for (int c = 0; c < key_chunks; ++c) sq += dq_part[c * n_q + e];
  const int i = static_cast<int>(e % d);
  const long long rest = e / d;
  const int n = static_cast<int>(rest % N);
  const int bh = static_cast<int>(rest / N);
  const int b = bh / heads;
  const int hh = bh % heads;
  dq[b * dqs.b + hh * dqs.h + n * dqs.n + i] = from_f32<T>(sq);
}

template <typename T>
int launch_reduce(const BwdArgs& a, cudaStream_t s) {
  const long long n_kv = static_cast<long long>(a.B) * a.heads * a.M * a.d;
  const long long n_q =
      a.key_chunks > 1 ? static_cast<long long>(a.B) * a.heads * a.N * a.d
                       : 0;
  sra_bwd_reduce<T>
      <<<static_cast<unsigned>((n_kv + n_q + 255) / 256), 256, 0, s>>>(
          a.part_dk, a.part_dv, a.splits, a.heads, a.M, a.d, n_kv,
          static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.dks, a.dvs,
          a.dq_part, a.key_chunks, a.N, n_q, static_cast<T*>(a.dq), a.dqs);
  return static_cast<int>(cudaGetLastError());
}

// Whether the caller's plan fits the kernel's: the key chunks cover M.
bool bad_plan(const BwdArgs& a, int keys_per_block) {
  return static_cast<long long>(a.key_chunks) * keys_per_block < a.M ||
         (a.key_chunks - 1) * keys_per_block >= a.M ||
         (a.key_chunks > 1) != (a.dq_part != nullptr);
}

template <int DP>
int launch_mma(const BwdArgs& a, cudaStream_t s) {
  using P = MmaPlan<DP>;
  if (bad_plan(a, P::KS)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = sra_bwd_mma<DP>;
  static bool allowed[kMaxDevices] = {};
  int err = allow_shared_memory(kernel, P::smem, allowed);
  if (err != 0) return err;
  const dim3 grid(a.splits, a.key_chunks, a.B * a.heads);
  kernel<<<grid, kMmaThreads, P::smem, s>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.o,
      static_cast<const __nv_bfloat16*>(a.g), a.lse, a.part_dk, a.part_dv,
      a.dq_part, static_cast<__nv_bfloat16*>(a.dq), a.heads, a.N, a.M, a.d,
      a.rows_per_split, a.qs, a.ks, a.vs, a.os, a.gs, a.dqs, a.scale);
  err = static_cast<int>(cudaGetLastError());
  return err != 0 ? err : launch_reduce<__nv_bfloat16>(a, s);
}

template <int DP>
int launch_f32(const BwdArgs& a, cudaStream_t s) {
  using P = F32Plan<DP>;
  if (bad_plan(a, P::KS)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = sra_bwd_f32<DP>;
  static bool allowed[kMaxDevices] = {};
  int err = allow_shared_memory(kernel, P::smem, allowed);
  if (err != 0) return err;
  const dim3 grid(a.splits, a.key_chunks, a.B * a.heads);
  kernel<<<grid, kF32Threads, P::smem, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.o, static_cast<const float*>(a.g),
      a.lse, a.part_dk, a.part_dv, a.dq_part, static_cast<float*>(a.dq),
      a.heads, a.N, a.M, a.d, a.rows_per_split, a.qs, a.ks, a.vs, a.os, a.gs,
      a.dqs, a.scale);
  err = static_cast<int>(cudaGetLastError());
  return err != 0 ? err : launch_reduce<float>(a, s);
}

}  // namespace

// q, k, v: the forward's inputs; o: its output in float32 (out32, or out
// itself for float32 inputs), with strides; g: dO in the inputs' dtype;
// lse: the forward's. strides: 24 values, the (b, h, n) strides of q, k, v,
// o, g, dq, dk, dv in that order, rows at multiples of 16 bytes. The split
// s covers query rows [s * rows_per_split, (s + 1) * rows_per_split); the
// keys are cut into key_chunks chunks of the kernel's resident key count
// (MmaPlan / F32Plan: the wrapper plans with the same numbers, and a plan
// that does not fit is refused). Scratch: part_dk and part_dv, splits *
// B*h * M * d float32 each; dq_part, key_chunks * B*h * N * d float32 where
// key_chunks > 1, else nullptr. Outputs dq, dk, dv in the inputs' dtype,
// every element written.
extern "C" int sra_attn_bwd(const void* q, const void* k, const void* v,
                            const float* o, const void* g, const float* lse,
                            float* part_dk, float* part_dv, float* dq_part,
                            void* dq, void* dk, void* dv, int B, int heads,
                            int N, int M, int d, int splits,
                            int rows_per_split, int key_chunks,
                            const long long* strides, float scale, int dtype,
                            void* stream) {
  if (sra::bad_shape(B, heads, N, M, d) || splits < 1 ||
      rows_per_split < 1 || key_chunks < 1 || key_chunks > 65535 ||
      static_cast<long long>(splits) * rows_per_split < N || dtype < 0 ||
      dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdArgs a = {q, k, v, o, g, lse, part_dk, part_dv, dq_part, dq, dk,
                     dv, B, heads, N, M, d, splits, rows_per_split,
                     key_chunks,
                     sra::strides_at(strides, 0), sra::strides_at(strides, 1),
                     sra::strides_at(strides, 2), sra::strides_at(strides, 3),
                     sra::strides_at(strides, 4), sra::strides_at(strides, 5),
                     sra::strides_at(strides, 6), sra::strides_at(strides, 7),
                     scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = sra::padded_dim(d);
  if (dtype == 1) {
    return dp == 32 ? launch_mma<32>(a, s)
                    : (dp == 64 ? launch_mma<64>(a, s) : launch_mma<128>(a, s));
  }
  return dp == 32 ? launch_f32<32>(a, s)
                  : (dp == 64 ? launch_f32<64>(a, s) : launch_f32<128>(a, s));
}
