// K2: MiT spatial-reduction attention for Hopper (sm_90a), forward.
//
// Replaces segdistill_tpu/ops/pallas/sra_attn.py::fused_sra_attention (the
// pallas_call at sra_attn.py:78) and is the forward of sra_attention_train
// (its backward, K9, is sra_attn_bwd.cu):
//
//   out = softmax(q @ k^T * scale) @ v,   q (B, h, N, d), k/v (B, h, M, d)
//
// The (N, M) score plane never reaches device memory; the softmax is fp32
// and online (running max and sum per row, in base 2 with scale * log2(e)
// folded into one multiply), so any M works; rows past N are computed and
// not stored, so any N works. For training it also stores each row's
// log-sum-exp of the scaled scores and, for bf16 inputs, the output in fp32
// (K9 forms the row term D = rowsum(dO o O) from it).
//
// What bounds it on this card: operations. At B0 stage 1 (512^2 input) a
// row does 4*M*d = 32k FLOPs against 128 bytes of its own traffic; K/V are
// shared by all rows of a head and stay in L2. At d = 32 the M exponentials
// of a row cost as much as its products on the tensor cores, so the
// products must leave the CUDA cores and the softmax must stay cheap.
//
// bf16 inputs: tensor cores, mma.sync.m16n8k16 with bf16 operands and fp32
// sums (not wgmma: at d = 32 the two products are ~4 us of the card at
// full rate, less than the exponentials, so wgmma's extra rate buys little
// and its shared-memory descriptors are where a hand-written kernel goes
// wrong). A block of 4 warps owns 64 query rows, 16 a warp (at d = 64 on
// large grids 128 rows, 32 a warp); the Q fragments and the fp32 output
// sums live in registers (d/2 each: no spill at d = 128); up to KS keys of
// the head's K and V sit in shared memory as bf16, loaded once per block
// with 16-byte cp.async, rows padded by 16 bytes so that ldmatrix is free
// of bank conflicts (V is read with ldmatrix.trans).
// Keys go 64 at a time: S = Q K^T in the accumulator
// layout, row max and sum by shuffles over the 4 lanes that share a row,
// P = exp2(S - max) rounded to bf16 in registers as the A operand of
// O += P V. The JAX kernel rounds the normalised P to bf16; this one
// rounds exp(s - running max) and divides the fp32 sum at the end.
//
// fp32 inputs: full fp32 on CUDA cores (no TF32: the fp32 model is held to
// 1e-5 of its largest logit against the CPU). Four lanes share a query
// row: they split the head dim in slices of 32 (d = 64: 2, d = 128: 4) and
// the keys among the rest (d = 32: 4 key lanes), so q and the output sums
// take 32 registers a row at every d. A thread owns two rows (32 apart),
// has four key dots in flight per row, reads K and V from shared memory as
// float4 (one load per eight FMAs: with one row a thread, shared-memory
// reads and not FMAs bounded the kernel) and handles 16 keys per chunk
// before it touches the running max; the key lanes merge their (max, sum,
// output) at the end. Shared rows are padded so the four lanes of a row
// hit different banks.
//
// Strides: q, k, v and the outputs are addressed as (b, h, n) strides with
// a contiguous last dim, so the caller's head-split views need no copy;
// every row must start at a multiple of 16 bytes (the wrapper copies what
// does not).
//
// Plain C interface, loaded with ctypes; returns the CUDA error code.

#include "sra_common.cuh"

namespace {

using namespace sra;

// ---------------------------------------------------------------- bf16
constexpr int kMmaThreads = 128;  // 4 warps x MT tiles of 16 query rows
constexpr int kSMs = 132;         // of the card the shapes are planned for

template <int DP, int KS, int MT>
__global__ void __launch_bounds__(kMmaThreads)
    sra_fwd_mma(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                float* __restrict__ out32, int heads, int N, int M, int d,
                Strides qs, Strides ks, Strides vs, Strides os,
                float scale_log2_signed) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + KS * LD;

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int hh = bh % heads;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const __nv_bfloat16* q_head = q + b * qs.b + hh * qs.h;
  const __nv_bfloat16* k_head = k + b * ks.b + hh * ks.h;
  const __nv_bfloat16* v_head = v + b * vs.b + hh * vs.h;

  // this thread's rows: row0 + 16 * mt and 8 below, mt < MT
  const int row0 = (blockIdx.x * 4 + warp) * 16 * MT + g;

  // The running max is kept on the raw scores and the scale folded into
  // the exponent's one FMA, which needs a positive scale: a negative one
  // moves into q's sign bits.
  const float scale_log2 = fabsf(scale_log2_signed);
  const uint32_t flip = scale_log2_signed < 0.0f ? 0x80008000u : 0u;
  // Q fragments straight from device memory (each element is read once)
  uint32_t qf[MT][DP / 16][4];
  float o[MT][DP / 8][4];
  float m_run[MT][2];  // running max (raw scores) of rows + 0 and + 8
  float l_run[MT][2];  // this lane's share of the sums
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + 16 * mt + 8 * (i & 1);
        const int col = kk * 16 + 2 * t + (i >> 1) * 8;
        qf[mt][kk][i] = (row < N && col < d)
                            ? *reinterpret_cast<const uint32_t*>(
                                  q_head + row * qs.n + col) ^ flip
                            : 0u;
      }
    }
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      o[mt][nt][0] = o[mt][nt][1] = o[mt][nt][2] = o[mt][nt][3] = 0.0f;
    }
    m_run[mt][0] = m_run[mt][1] = -INFINITY;
    l_run[mt][0] = l_run[mt][1] = 0.0f;
  }

  for (int c0 = 0; c0 < M; c0 += KS) {
    const int kc = min(KS, M - c0);
    __syncthreads();  // the previous keys have been consumed
    load_tile<__nv_bfloat16, KS, DP, LD, kMmaThreads>(
        k_s, k_head + c0 * ks.n, ks.n, kc, d);
    load_tile<__nv_bfloat16, KS, DP, LD, kMmaThreads>(
        v_s, v_head + c0 * vs.n, vs.n, kc, d);
    cp_async_wait_all();
    __syncthreads();

    for (int k0 = 0; k0 < kc; k0 += 64) {  // key k0 is valid
      float s[MT][8][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.0f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bf[4];  // one read of K feeds every row tile of the warp
          ldmatrix_x4(bf, b_frag<LD>(k_s, k0 + np * 16, kk * 16, lane));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][2 * np], qf[mt][kk], bf[0], bf[1]);
            mma_bf16(s[mt][2 * np + 1], qf[mt][kk], bf[2], bf[3]);
          }
        }
      }
      uint32_t pf[MT][4][4];  // P as A fragments, 16 keys each
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (k0 + 64 > kc) {  // only the last keys need a mask
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (k0 + nt * 8 + 2 * t + (e & 1) >= kc) {
                s[mt][nt][e] = -INFINITY;
              }
            }
          }
        }
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          mx_a = fmaxf(mx_a, fmaxf(s[mt][nt][0], s[mt][nt][1]));
          mx_b = fmaxf(mx_b, fmaxf(s[mt][nt][2], s[mt][nt][3]));
        }
#pragma unroll
        for (int mask = 1; mask < 4; mask <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, mask));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, mask));
        }
        const float m_a = m_run[mt][0], m_b = m_run[mt][1];
        const float mn_a = fmaxf(m_a, mx_a);  // finite: key k0 is valid
        const float mn_b = fmaxf(m_b, mx_b);
        // 0 on the first keys (also at scale 0, where -inf * 0 is no number)
        const float corr_a = m_a == -INFINITY
                                 ? 0.0f
                                 : fast_exp2((m_a - mn_a) * scale_log2);
        const float corr_b = m_b == -INFINITY
                                 ? 0.0f
                                 : fast_exp2((m_b - mn_b) * scale_log2);
        const float off_a = -mn_a * scale_log2;
        const float off_b = -mn_b * scale_log2;
        m_run[mt][0] = mn_a;
        m_run[mt][1] = mn_b;
        float l_a = l_run[mt][0] * corr_a, l_b = l_run[mt][1] * corr_b;
#pragma unroll
        for (int nt = 0; nt < DP / 8; ++nt) {
          o[mt][nt][0] *= corr_a;
          o[mt][nt][1] *= corr_a;
          o[mt][nt][2] *= corr_b;
          o[mt][nt][3] *= corr_b;
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          // exp2(s * scale * log2(e) - max); 0 for masked keys
          const float p0 = fast_exp2(fmaf(s[mt][nt][0], scale_log2, off_a));
          const float p1 = fast_exp2(fmaf(s[mt][nt][1], scale_log2, off_a));
          const float p2 = fast_exp2(fmaf(s[mt][nt][2], scale_log2, off_b));
          const float p3 = fast_exp2(fmaf(s[mt][nt][3], scale_log2, off_b));
          l_a += p0 + p1;
          l_b += p2 + p3;
          pf[mt][nt >> 1][(nt & 1) * 2] = pack_bf16(p0, p1);
          pf[mt][nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
        }
        l_run[mt][0] = l_a;
        l_run[mt][1] = l_b;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int dp = 0; dp < DP / 16; ++dp) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf,
                            bt_frag<LD>(v_s, k0 + kk * 16, dp * 16, lane));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(o[mt][2 * dp], pf[mt][kk], bf[0], bf[1]);
            mma_bf16(o[mt][2 * dp + 1], pf[mt][kk], bf[2], bf[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float l = l_run[mt][half];
#pragma unroll
      for (int mask = 1; mask < 4; mask <<= 1) {
        l += __shfl_xor_sync(0xffffffffu, l, mask);
      }
      const int row = row0 + 16 * mt + 8 * half;
      if (row >= N) continue;
      const float inv = 1.0f / l;
      const long long off = b * os.b + hh * os.h + row * os.n;
#pragma unroll
      for (int nt = 0; nt < DP / 8; ++nt) {
        const int col = nt * 8 + 2 * t;
        if (col < d) {
          const float x = o[mt][nt][2 * half] * inv;
          const float y = o[mt][nt][2 * half + 1] * inv;
          *reinterpret_cast<uint32_t*>(out + off + col) = pack_bf16(x, y);
          if (out32 != nullptr) {
            *reinterpret_cast<float2*>(out32 + off + col) =
                make_float2(x, y);
          }
        }
      }
      if (lse != nullptr && t == 0) {
        lse[static_cast<long long>(bh) * N + row] =
            (m_run[mt][half] * scale_log2 + log2f(l)) * kLn2;
      }
    }
  }
}

// ---------------------------------------------------------------- fp32
constexpr int kF32Threads = 128;  // 32 x 4 lanes, two query rows each
constexpr int kF32Rows = 64;
constexpr int kRowsPerThread = 2;  // a K or V value read feeds two rows
constexpr int kKeysPerLane = 16;   // keys a thread handles per chunk

template <int DP>
__global__ void __launch_bounds__(kF32Threads)
    sra_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out,
                float* __restrict__ lse, int heads, int N, int M, int d,
                Strides qs, Strides ks, Strides vs, Strides os,
                float scale_log2) {
  constexpr int R = kRowsPerThread;
  constexpr int DL = DP / 32;             // lanes that split the head dim
  constexpr int KL = 4 / DL;              // lanes that split the keys
  constexpr int KC = kKeysPerLane * KL;   // keys per chunk
  constexpr int LD = DP + 4 * DL;         // the 4 lanes hit 4 bank groups
  __shared__ __align__(16) float k_s[KC * LD];
  __shared__ __align__(16) float v_s[KC * LD];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int hh = bh % heads;
  // rows row0 and row0 + 32
  const int row0 = blockIdx.x * kF32Rows + (threadIdx.x >> 2);
  const int l4 = threadIdx.x & 3;
  const int dl = l4 % DL;  // dims (c * DL + dl) * 4 .. + 3, c = 0..7
  const int kl = l4 / DL;  // keys j * KL + kl of a chunk, j = 0..15

  const float* k_head = k + b * ks.b + hh * ks.h;
  const float* v_head = v + b * vs.b + hh * vs.h;

  float q_r[R][32];
  float acc[R][32];
  float m_run[R], l_run[R];  // base-2 running max, sum
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + 32 * r;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = (c * DL + dl) * 4;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row < N && col < d) {
        x = *reinterpret_cast<const float4*>(q + b * qs.b + hh * qs.h +
                                             row * qs.n + col);
      }
      q_r[r][4 * c] = x.x;
      q_r[r][4 * c + 1] = x.y;
      q_r[r][4 * c + 2] = x.z;
      q_r[r][4 * c + 3] = x.w;
      acc[r][4 * c] = acc[r][4 * c + 1] = 0.0f;
      acc[r][4 * c + 2] = acc[r][4 * c + 3] = 0.0f;
    }
    m_run[r] = -INFINITY;
    l_run[r] = 0.0f;
  }

  for (int c0 = 0; c0 < M; c0 += KC) {
    const int kc = min(KC, M - c0);
    __syncthreads();  // the previous chunk has been consumed
    load_tile<float, KC, DP, LD, kF32Threads>(k_s, k_head + c0 * ks.n, ks.n,
                                              kc, d);
    load_tile<float, KC, DP, LD, kF32Threads>(v_s, v_head + c0 * vs.n, vs.n,
                                              kc, d);
    cp_async_wait_all();
    __syncthreads();

    float s[R][kKeysPerLane];
#pragma unroll
    for (int j0 = 0; j0 < kKeysPerLane; j0 += 4) {
      float dot[R][4];  // four keys in flight per row
#pragma unroll
      for (int r = 0; r < R; ++r) {
        dot[r][0] = dot[r][1] = dot[r][2] = dot[r][3] = 0.0f;
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 x = *reinterpret_cast<const float4*>(
              &k_s[((j0 + u) * KL + kl) * LD + (c * DL + dl) * 4]);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            dot[r][u] = fmaf(q_r[r][4 * c], x.x, dot[r][u]);
            dot[r][u] = fmaf(q_r[r][4 * c + 1], x.y, dot[r][u]);
            dot[r][u] = fmaf(q_r[r][4 * c + 2], x.z, dot[r][u]);
            dot[r][u] = fmaf(q_r[r][4 * c + 3], x.w, dot[r][u]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int u = 0; u < 4; ++u) s[r][j0 + u] = dot[r][u];
      }
    }
    float m_safe[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float c_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) {
#pragma unroll
        for (int mask = 1; mask < DL; mask <<= 1) {
          s[r][j] += __shfl_xor_sync(0xffffffffu, s[r][j], mask);
        }
        s[r][j] = (j * KL + kl < kc) ? s[r][j] * scale_log2 : -INFINITY;
        c_max = fmaxf(c_max, s[r][j]);
      }
      // a key lane may hold no valid key yet: its state stays (-inf, 0)
      const float m_new = fmaxf(m_run[r], c_max);
      m_safe[r] = m_new == -INFINITY ? 0.0f : m_new;
      const float corr = exp2f(m_run[r] - m_safe[r]);  // 0 on the first keys
      m_run[r] = m_new;
      l_run[r] *= corr;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[r][i] *= corr;
    }
#pragma unroll
    for (int j = 0; j < kKeysPerLane; ++j) {
      float p[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        p[r] = exp2f(s[r][j] - m_safe[r]);  // 0 for masked keys
        l_run[r] += p[r];
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 x = *reinterpret_cast<const float4*>(
            &v_s[(j * KL + kl) * LD + (c * DL + dl) * 4]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[r][4 * c] = fmaf(p[r], x.x, acc[r][4 * c]);
          acc[r][4 * c + 1] = fmaf(p[r], x.y, acc[r][4 * c + 1]);
          acc[r][4 * c + 2] = fmaf(p[r], x.z, acc[r][4 * c + 2]);
          acc[r][4 * c + 3] = fmaf(p[r], x.w, acc[r][4 * c + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    // merge the key lanes of a row: (max, sum, output) pairs
#pragma unroll
    for (int mask = DL; mask < 4; mask <<= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m_run[r], mask);
      const float l_o = __shfl_xor_sync(0xffffffffu, l_run[r], mask);
      const float m_new = fmaxf(m_run[r], m_o);
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      const float wa = exp2f(m_run[r] - m_safe);
      const float wb = exp2f(m_o - m_safe);
      l_run[r] = l_run[r] * wa + l_o * wb;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float a_o = __shfl_xor_sync(0xffffffffu, acc[r][i], mask);
        acc[r][i] = acc[r][i] * wa + a_o * wb;
      }
      m_run[r] = m_new;
    }
    const int row = row0 + 32 * r;
    if (row < N && kl == 0) {
      const float inv_l = 1.0f / l_run[r];
      const long long off = b * os.b + hh * os.h + row * os.n;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = (c * DL + dl) * 4;
        if (col < d) {
          *reinterpret_cast<float4*>(out + off + col) = make_float4(
              acc[r][4 * c] * inv_l, acc[r][4 * c + 1] * inv_l,
              acc[r][4 * c + 2] * inv_l, acc[r][4 * c + 3] * inv_l);
        }
      }
      if (lse != nullptr && dl == 0) {
        lse[static_cast<long long>(bh) * N + row] =
            (m_run[r] + log2f(l_run[r])) * kLn2;
      }
    }
  }
}

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  float* out32;
  int B, heads, N, M, d;
  Strides qs, ks, vs, os;
  float scale;
};

// Keys of a head resident in shared memory per pass of the bf16 kernel.
constexpr int fwd_keys(int DP) { return DP <= 64 ? 256 : 128; }

// MT: the tiles of 16 query rows a warp owns.
template <int DP, int MT>
int launch_mma(const FwdArgs& a, cudaStream_t stream) {
  constexpr int KS = fwd_keys(DP);
  constexpr int smem = 2 * KS * (DP + 8) * 2;
  auto kernel = sra_fwd_mma<DP, KS, MT>;
  static bool allowed[kMaxDevices] = {};
  const int err = allow_shared_memory(kernel, smem, allowed);
  if (err != 0) return err;
  const dim3 grid((a.N + 64 * MT - 1) / (64 * MT), a.B * a.heads);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<__nv_bfloat16*>(a.out), a.lse, a.out32, a.heads, a.N, a.M,
      a.d, a.qs, a.ks, a.vs, a.os, a.scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_f32(const FwdArgs& a, cudaStream_t stream) {
  const dim3 grid((a.N + kF32Rows - 1) / kF32Rows, a.B * a.heads);
  sra_fwd_f32<DP><<<grid, kF32Threads, 0, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.lse,
      a.heads, a.N, a.M, a.d, a.qs, a.ks, a.vs, a.os, a.scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 values in elements, the (b, h, n) strides of q, k, v and out
// in that order; the last dim is contiguous and every row starts at a
// multiple of 16 bytes. dtype: 0 float32, 1 bfloat16. d <= 128 and
// d % 8 == 0. lse (B*h, N) float32 and,
// for bfloat16, out32 (out's shape and strides, float32) are optional
// outputs for the backward: nullptr leaves them out.
extern "C" int sra_attn_fwd(const void* q, const void* k, const void* v,
                            void* out, int B, int heads, int N, int M, int d,
                            const long long* strides, float scale, int dtype,
                            float* lse, float* out32,
                            void* stream) {
  if (sra::bad_shape(B, heads, N, M, d) || dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FwdArgs a = {q, k, v, out, lse, out32, B, heads, N, M, d,
                     sra::strides_at(strides, 0), sra::strides_at(strides, 1),
                     sra::strides_at(strides, 2), sra::strides_at(strides, 3),
                     scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = sra::padded_dim(d);
  if (dtype == 1) {
    if (dp == 32) return launch_mma<32, 1>(a, s);
    if (dp == 128) return launch_mma<128, 1>(a, s);
    // d = 64: 32 rows a warp (each K and V fragment read from shared memory
    // feeds two row tiles) where blocks of 128 rows still give every SM
    // one; measured on an H100 0.0176 against 0.0256 ms at N = 16384, two
    // heads, and slower than 16 rows a warp on small grids. At d = 32 it
    // gains nothing.
    const long long blocks128 =
        static_cast<long long>((N + 127) / 128) * B * heads;
    return blocks128 >= kSMs ? launch_mma<64, 2>(a, s)
                             : launch_mma<64, 1>(a, s);
  }
  return dp == 32 ? launch_f32<32>(a, s)
                  : (dp == 64 ? launch_f32<64>(a, s) : launch_f32<128>(a, s));
}
