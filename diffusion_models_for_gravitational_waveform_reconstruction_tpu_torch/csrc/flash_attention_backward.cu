// Backward of flash attention for Hopper (sm_90a): the gradients (dq, dk,
// dv) of non-causal softmax(Q K^T / sqrt(D)) V on (B*H, L, D) tensors in f32
// or bf16, given dout and the forward's output, in the input dtype.
//
// The JAX package has no kernel for this: its Pallas flash attention
// (diffusion_models_for_gravitational_waveform_reconstruction_tpu/ops/pallas/attention.py:70)
// is forward-only, and its trainer differentiates the plain expression
// flash_attention_reference (attention.py:27-33) with XLA's autodiff.  This
// kernel computes the gradients of the port's plain backward
// (ops/kernels/flash_attention.py::flash_attention_backward), FlashAttention-2
// style, with nothing of size L x L in device memory:
//   flash_bwd_pre   - per query row, delta = rowsum(dO * O) in f32 and the
//                     log-sum-exp of the scaled scores (log2 units),
//                     recomputed by a statistics-only pass over the keys;
//   flash_bwd_dkdv  - one CTA per (b*h, 64-key tile, 64 columns of D) walks
//                     the query tiles: S^T = K Q^T, P^T = exp2(S^T c - lse),
//                     dV += P^T dO (P in v's dtype), dP^T = V dO^T,
//                     dS^T = P^T (dP^T - delta), dK += dS^T Q;
//   flash_bwd_dq    - one CTA per (b*h, 64-query tile, 64 columns of D) walks
//                     the key tiles: the same P and dS, dQ += dS K;
// then dK and dQ times 1 / sqrt(D).  Each output element is summed by one
// thread in a fixed order: no float atomics, deterministic.  A CTA whose D
// is wider than 64 recomputes S and dP for each 64 columns of its outputs.
// P and dS are rounded to bf16 as the A operands of dV, dK and dQ (the
// plain backward rounds P for dV and keeps dS in f32).  Three routes:
//   wgmma (bf16, D 64 or 128, q, k, v and dout on 16-byte aligned rows): one
//     warpgroup a CTA, every product on wgmma m64n64k16 with the tiles
//     copied by cp.async into the 128-byte swizzled layout, P and dS as
//     register A operands (the training route: attn16k's D is 64);
//   mma_sync (other bf16): four warps, mma.sync m16n8k16, the B operands
//     that are M-major in shared memory (dO and Q for dV and dK, K for dQ)
//     through ldmatrix.trans;
//   fma (f32): the FMA units (no TF32), D in chunks of 64.
// dout may be strided (the U-Net hands it transposed): element (b, h, l,
// d) at b sb + h sh + l sl + d.
//
// What bounds it on the H100.  Five products of 2 B H L^2 D FLOPs (S in the
// LSE pass and twice more, dP twice, dV, dK, dQ: seven with the recomputes)
// against q, k, v, o, dout and the three outputs read or written once: at
// attn16k's (16, 4, 4096, 64) about 690 GFLOP for 0.2 GB, so the tensor-core
// rate bounds it.  The wgmma route runs 8 products (S three times, dP twice)
// one tile at a time without a copy pipeline: on an H100 a second consumer
// warpgroup per CTA was slower (one CTA an SM) and double-buffered tiles no
// faster; a TMA ring with warp-specialised producers, as K2's forward has,
// is later work.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BT = 64;        // query rows or keys per tile
constexpr int THREADS = 128;  // four warps
constexpr int MAX_D = 256;
constexpr int TS = BT + 1;    // row stride of the f32 transposed tiles
constexpr int CHUNK = 64;     // columns of D per output CTA; f32 D chunk
constexpr int ROUTE_FMA = 0, ROUTE_MMA_SYNC = 1, ROUTE_WGMMA = 2;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Where (b*h) starts in dout, and its row stride.
struct Strides {
  int H;
  int64_t sb, sh, sl;
  __device__ int64_t base(int bh) const {
    return (int64_t)(bh / H) * sb + (int64_t)(bh % H) * sh;
  }
};

// 64 rows from row0 of an (L, D) bf16 matrix with row stride ld into
// dst[64][DP + 8], zero past L and past D; 16-byte loads when vec.
template <int DP>
__device__ void load_rows(__nv_bfloat16* dst,
                          const __nv_bfloat16* __restrict__ src, int row0,
                          int L, int D, int64_t ld, int vec) {
  constexpr int S = DP + 8;
  if (vec) {
    constexpr int CH = DP / 8;
    for (int idx = threadIdx.x; idx < BT * CH; idx += THREADS) {
      const int r = idx / CH, c = (idx % CH) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < L && c < D)
        val = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * ld + c);
      *reinterpret_cast<uint4*>(dst + r * S + c) = val;
    }
  } else {
    for (int idx = threadIdx.x; idx < BT * DP; idx += THREADS) {
      const int r = idx / DP, c = idx % DP;
      __nv_bfloat16 val = __float2bfloat16(0.f);
      if (row0 + r < L && c < D) val = src[(int64_t)(row0 + r) * ld + c];
      dst[r * S + c] = val;
    }
  }
}

// acc[n][4] += A(rows r0, r0 + 8 of `a`) B^T(rows of `b`): 16 rows of `a`
// against 64 rows of `b` (8 tiles of 8), contracted over DP columns; both
// [64][DP + 8] bf16 in shared memory.
template <int DP>
__device__ __forceinline__ void gemm_abt(float (*acc)[4],
                                         const __nv_bfloat16* a,
                                         const __nv_bfloat16* b, int r0,
                                         int g, int t) {
  constexpr int S = DP + 8;
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd) {
    uint32_t af[4];
    const __nv_bfloat16* p = a + r0 * S + kd * 16 + 2 * t;
    af[0] = ld32(p);
    af[1] = ld32(p + 8 * S);
    af[2] = ld32(p + 8);
    af[3] = ld32(p + 8 * S + 8);
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) {
      const __nv_bfloat16* q = b + (n * 8 + g) * S + kd * 16 + 2 * t;
      mma_bf16(acc[n], af, ld32(q), ld32(q + 8));
    }
  }
}

// acc[nd][4] += X(16 rows, 64 k, f32 accumulator layout in x[8][4], rounded
// to bf16) M[k rows][c0 .. c0 + NC): the A operand from registers, M through
// ldmatrix.trans from [64][DP + 8] bf16 in shared memory.
template <int DP, int NC>
__device__ __forceinline__ void gemm_xm(float (*acc)[4], float (*x)[4],
                                        const __nv_bfloat16* m, int c0,
                                        int lane) {
  constexpr int S = DP + 8;
  const int mat = lane >> 3, mrow = lane & 7;
#pragma unroll
  for (int kc = 0; kc < BT / 16; ++kc) {
    uint32_t pa[4];
    pa[0] = pack_bf16(x[2 * kc][0], x[2 * kc][1]);
    pa[1] = pack_bf16(x[2 * kc][2], x[2 * kc][3]);
    pa[2] = pack_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1]);
    pa[3] = pack_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3]);
#pragma unroll
    for (int nd2 = 0; nd2 < NC / 16; ++nd2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, m + (kc * 16 + (mat & 1) * 8 + mrow) * S + c0 +
                           nd2 * 16 + (mat >> 1) * 8);
      mma_bf16(acc[2 * nd2], pa, b[0], b[1]);
      mma_bf16(acc[2 * nd2 + 1], pa, b[2], b[3]);
    }
  }
}

// Rows r0, r0 + 8 of a 16-row accumulator (x[n][4], n < N) times `scale`,
// into out (row stride D) in bf16: rows < n_rows, columns c0 + ... < D.
template <int N>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           float (*x)[4], int row,
                                           int n_rows, int c0, int D,
                                           float scale, int t) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + 8 * (e >> 1), c = c0 + n * 8 + 2 * t + (e & 1);
      if (r < n_rows && c < D)
        out[(int64_t)r * D + c] = __float2bfloat16(x[n][e] * scale);
    }
}

// delta[row] = sum over d of dO[row][d] O[row][d] in f32, for rows q0 ..
// q0 + 63 of head bh: two threads a row.
template <typename T>
__device__ void row_delta(const T* __restrict__ dout, const Strides st,
                          const T* __restrict__ o, float* __restrict__ delta,
                          int bh, int q0, int L, int D) {
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1, row = q0 + r;
  float s = 0.f;
  if (row < L) {
    const T* dr = dout + st.base(bh) + (int64_t)row * st.sl;
    const T* orow = o + ((int64_t)bh * L + row) * D;
    for (int d = half; d < D; d += 2) s += to_f(dr[d]) * to_f(orow[d]);
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  if (half == 0 && row < L) delta[(int64_t)bh * L + row] = s;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync.

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_pre_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ o,
                   const __nv_bfloat16* __restrict__ dout, const Strides st,
                   float* __restrict__ lse, float* __restrict__ delta, int L,
                   int D, float c, int vec) {
  constexpr int S = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + BT * S;
  const int q0 = blockIdx.x * BT, bh = blockIdx.y;
  const int64_t base = (int64_t)bh * L * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16 + g;

  row_delta(dout, st, o, delta, bh, q0, L, D);
  load_rows<DP>(qs, q + base, q0, L, D, D, vec);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < L; k0 += BT) {
    __syncthreads();
    load_rows<DP>(ks, k + base, k0, L, D, D, vec);
    __syncthreads();
    float s[BT / 8][4];
#pragma unroll
    for (int n = 0; n < BT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    gemm_abt<DP>(s, qs, ks, r0, g, t);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = k0 + n * 8 + 2 * t + (e & 1) < L ? s[n][e] * c : -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(m[i], quad_max(mx[i]));  // finite: key k0 < L
      l[i] *= exp2f(m[i] - mn);
      m[i] = mn;
    }
#pragma unroll
    for (int n = 0; n < BT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e >> 1] += exp2f(s[n][e] - m[e >> 1]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float tot = quad_sum(l[i]);
    const int row = q0 + r0 + 8 * i;
    if (t == 0 && row < L) lse[(int64_t)bh * L + row] = m[i] + log2f(tot);
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout, const Strides st,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int L, int D, float c,
                    float scale, int vec, int vec_do) {
  constexpr int S = DP + 8, NC = DP < CHUNK ? DP : CHUNK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + BT * S;
  __nv_bfloat16* qs = vs + BT * S;
  __nv_bfloat16* dos = qs + BT * S;
  float* lse_s = reinterpret_cast<float*>(dos + BT * S);
  float* dl_s = lse_s + BT;
  const int kt0 = blockIdx.x * BT, bh = blockIdx.y, c0 = blockIdx.z * NC;
  const int64_t base = (int64_t)bh * L * D;
  const __nv_bfloat16* dob = dout + st.base(bh);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16 + g;

  load_rows<DP>(ks, k + base, kt0, L, D, D, vec);
  load_rows<DP>(vs, v + base, kt0, L, D, D, vec);
  float dka[NC / 8][4], dva[NC / 8][4];
#pragma unroll
  for (int n = 0; n < NC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int q0 = 0; q0 < L; q0 += BT) {
    __syncthreads();
    load_rows<DP>(qs, q + base, q0, L, D, D, vec);
    load_rows<DP>(dos, dob, q0, L, D, st.sl, vec_do);
    if (threadIdx.x < BT) {
      const int row = q0 + threadIdx.x;
      // rows past L: P = exp2(-inf) = 0 and delta 0, so they add nothing
      lse_s[threadIdx.x] = row < L ? lse[(int64_t)bh * L + row] : INFINITY;
      dl_s[threadIdx.x] = row < L ? delta[(int64_t)bh * L + row] : 0.f;
    }
    __syncthreads();
    // S^T (this warp's 16 keys x 64 queries) and P^T
    float p[BT / 8][4], dp[BT / 8][4];
#pragma unroll
    for (int n = 0; n < BT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n][e] = dp[n][e] = 0.f;
    gemm_abt<DP>(p, ks, qs, r0, g, t);
#pragma unroll
    for (int n = 0; n < BT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[n][e] = exp2f(p[n][e] * c - lse_s[n * 8 + 2 * t + (e & 1)]);
    gemm_xm<DP, NC>(dva, p, dos, c0, lane);   // dV += P^T dO
    gemm_abt<DP>(dp, vs, dos, r0, g, t);      // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < BT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[n][e] = p[n][e] * (dp[n][e] - dl_s[n * 8 + 2 * t + (e & 1)]);
    gemm_xm<DP, NC>(dka, dp, qs, c0, lane);   // dK += dS^T Q
  }
  store_rows<NC / 8>(dk + base, dka, kt0 + r0, L, c0, D, scale, t);
  store_rows<NC / 8>(dv + base, dva, kt0 + r0, L, c0, D, 1.f, t);
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout, const Strides st,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int L, int D, float c,
                  float scale, int vec, int vec_do) {
  constexpr int S = DP + 8, NC = DP < CHUNK ? DP : CHUNK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + BT * S;
  __nv_bfloat16* ks = dos + BT * S;
  __nv_bfloat16* vs = ks + BT * S;
  const int q0 = blockIdx.x * BT, bh = blockIdx.y, c0 = blockIdx.z * NC;
  const int64_t base = (int64_t)bh * L * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16 + g;

  load_rows<DP>(qs, q + base, q0, L, D, D, vec);
  load_rows<DP>(dos, dout + st.base(bh), q0, L, D, st.sl, vec_do);
  float lr[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    lr[i] = row < L ? lse[(int64_t)bh * L + row] : 0.f;
    dl[i] = row < L ? delta[(int64_t)bh * L + row] : 0.f;
  }
  float dqa[NC / 8][4];
#pragma unroll
  for (int n = 0; n < NC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BT) {
    __syncthreads();
    load_rows<DP>(ks, k + base, k0, L, D, D, vec);
    load_rows<DP>(vs, v + base, k0, L, D, D, vec);
    __syncthreads();
    float p[BT / 8][4], dp[BT / 8][4];
#pragma unroll
    for (int n = 0; n < BT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n][e] = dp[n][e] = 0.f;
    gemm_abt<DP>(p, qs, ks, r0, g, t);       // S = Q K^T
    gemm_abt<DP>(dp, dos, vs, r0, g, t);     // dP = dO V^T
#pragma unroll
    for (int n = 0; n < BT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = k0 + n * 8 + 2 * t + (e & 1) < L
                             ? exp2f(p[n][e] * c - lr[e >> 1])
                             : 0.f;
        dp[n][e] = pe * (dp[n][e] - dl[e >> 1]);
      }
    gemm_xm<DP, NC>(dqa, dp, ks, c0, lane);  // dQ += dS K
  }
  store_rows<NC / 8>(dq + base, dqa, q0 + r0, L, c0, D, scale, t);
}

// ---------------------------------------------------------------------------
// f32: the FMA units.  Thread (tx, ty) of 8 x 16 owns rows ty * 4 + i
// (i < 4) of a tile and columns tx + 8 j (j < 8) of the other tile or of
// the CTA's 64 output columns; D is contracted in chunks of 64.

// 64 rows from row0 of an (L, D) f32 matrix with row stride ld, columns
// d0 .. d0 + 63, into dst[64][TS] transposed, zero past L and past D.
__device__ void load_t(float* dst, const float* __restrict__ src, int row0,
                       int L, int d0, int D, int64_t ld) {
  for (int idx = threadIdx.x; idx < BT * CHUNK; idx += THREADS) {
    const int r = idx / CHUNK, cc = idx % CHUNK;
    dst[cc * TS + r] = (row0 + r < L && d0 + cc < D)
                           ? src[(int64_t)(row0 + r) * ld + d0 + cc]
                           : 0.f;
  }
}

// s[i][j] += sum over the chunk's 64 columns of at[.][ty*4+i] bt[.][tx+8j]
__device__ __forceinline__ void chunk_abt(float (*s)[8], const float* at,
                                          const float* bt, int tx, int ty) {
#pragma unroll 4
  for (int d = 0; d < CHUNK; ++d) {
    float a[4], b[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = at[d * TS + ty * 4 + i];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = bt[d * TS + tx + 8 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// s = A B^T over all of D: A rows a_row0 .., B rows b_row0 .. (row stride
// lda / ldb), both through the transposed chunk buffers at, bt.
__device__ void gemm_abt_f32(float (*s)[8], float* at, float* bt,
                             const float* a, int a_row0, int64_t lda,
                             const float* b, int b_row0, int64_t ldb, int L,
                             int D, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += CHUNK) {
    __syncthreads();
    load_t(at, a, a_row0, L, d0, D, lda);
    load_t(bt, b, b_row0, L, d0, D, ldb);
    __syncthreads();
    chunk_abt(s, at, bt, tx, ty);
  }
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_pre_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ o, const float* __restrict__ dout,
                  const Strides st, float* __restrict__ lse,
                  float* __restrict__ delta, int L, int D, float c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* at = reinterpret_cast<float*>(smem_raw);
  float* bt = at + CHUNK * TS;
  const int q0 = blockIdx.x * BT, bh = blockIdx.y;
  const int64_t base = (int64_t)bh * L * D;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;

  row_delta(dout, st, o, delta, bh, q0, L, D);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < L; k0 += BT) {
    float s[4][8];
    gemm_abt_f32(s, at, bt, q + base, q0, D, k + base, k0, D, L, D, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x = k0 + tx + 8 * j < L ? s[i][j] * c : -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m[i], mx);
      l[i] *= exp2f(m[i] - mn);
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < 8; ++j) l[i] += exp2f(s[i][j] - mn);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    const int row = q0 + ty * 4 + i;
    if (tx == 0 && row < L) lse[(int64_t)bh * L + row] = m[i] + log2f(li);
  }
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout, const Strides st,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int L, int D, float c,
                   float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* at = reinterpret_cast<float*>(smem_raw);
  float* bt = at + CHUNK * TS;
  float* ps = bt + CHUNK * TS;    // [key][query]
  float* dss = ps + BT * TS;      // [key][query]
  float* lse_s = dss + BT * TS;
  float* dl_s = lse_s + BT;
  const int kt0 = blockIdx.x * BT, bh = blockIdx.y, c0 = blockIdx.z * CHUNK;
  const int64_t base = (int64_t)bh * L * D;
  const float* dob = dout + st.base(bh);
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;

  float dka[4][8], dva[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int q0 = 0; q0 < L; q0 += BT) {
    __syncthreads();
    if (threadIdx.x < BT) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < L ? lse[(int64_t)bh * L + row] : INFINITY;
      dl_s[threadIdx.x] = row < L ? delta[(int64_t)bh * L + row] : 0.f;
    }
    float p[4][8], dp[4][8];
    gemm_abt_f32(p, at, bt, k + base, kt0, D, q + base, q0, D, L, D, tx, ty);
    gemm_abt_f32(dp, at, bt, v + base, kt0, D, dob, q0, st.sl, L, D, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qq = tx + 8 * j, kk = ty * 4 + i;
        const float pe = exp2f(p[i][j] * c - lse_s[qq]);
        ps[kk * TS + qq] = pe;
        dss[kk * TS + qq] = pe * (dp[i][j] - dl_s[qq]);
      }
    __syncthreads();
    load_t(at, dob, q0, L, c0, D, st.sl);   // dO[:, c0 ..]^T
    load_t(bt, q + base, q0, L, c0, D, D);  // Q[:, c0 ..]^T
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < BT; ++qq) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ps[(ty * 4 + i) * TS + qq];
        dsv[i] = dss[(ty * 4 + i) * TS + qq];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float a = at[(tx + 8 * j) * TS + qq];
        const float b = bt[(tx + 8 * j) * TS + qq];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dva[i][j] = fmaf(pv[i], a, dva[i][j]);
          dka[i][j] = fmaf(dsv[i], b, dka[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = kt0 + ty * 4 + i, col = c0 + tx + 8 * j;
      if (row < L && col < D) {
        dk[base + (int64_t)row * D + col] = dka[i][j] * scale;
        dv[base + (int64_t)row * D + col] = dva[i][j];
      }
    }
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const Strides st, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int L, int D, float c, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* at = reinterpret_cast<float*>(smem_raw);
  float* bt = at + CHUNK * TS;
  float* dss = bt + CHUNK * TS;  // [query][key]
  const int q0 = blockIdx.x * BT, bh = blockIdx.y, c0 = blockIdx.z * CHUNK;
  const int64_t base = (int64_t)bh * L * D;
  const float* dob = dout + st.base(bh);
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;

  float lr[4], dl[4], dqa[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lr[i] = row < L ? lse[(int64_t)bh * L + row] : 0.f;
    dl[i] = row < L ? delta[(int64_t)bh * L + row] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) dqa[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < L; k0 += BT) {
    float p[4][8], dp[4][8];
    gemm_abt_f32(p, at, bt, q + base, q0, D, k + base, k0, D, L, D, tx, ty);
    gemm_abt_f32(dp, at, bt, dob, q0, st.sl, v + base, k0, D, L, D, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kk = tx + 8 * j;
        const float pe = k0 + kk < L ? exp2f(p[i][j] * c - lr[i]) : 0.f;
        dss[(ty * 4 + i) * TS + kk] = pe * (dp[i][j] - dl[i]);
      }
    __syncthreads();
    load_t(at, k + base, k0, L, c0, D, D);  // K[:, c0 ..]^T
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BT; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty * 4 + i) * TS + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float b = at[(tx + 8 * j) * TS + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i) dqa[i][j] = fmaf(dsv[i], b, dqa[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = q0 + ty * 4 + i, col = c0 + tx + 8 * j;
      if (row < L && col < D) dq[base + (int64_t)row * D + col] = dqa[i][j] * scale;
    }
}

// ---------------------------------------------------------------------------
// bf16 on wgmma (D 64 or 128; q, k, v and dout on 16-byte aligned rows).
// One warpgroup per CTA: the 64-row tiles land in shared memory through
// cp.async in the 128-byte swizzled layout that TMA would write (box of 64
// columns: 16-byte chunk c of row r at chunk c ^ (r & 7)), so one tile
// serves as a K-major operand (the contraction over D) and as an MN-major
// one (the contraction over its rows, with the descriptor's transpose
// bit).  The accumulator fragment of wgmma m64n64 is mma.sync's, one 16-row
// slice a warp, so P and dS go on as register A operands as above.

constexpr int SW_BOX = BT * 128;  // one 64-row box of 64 bf16 columns

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// every thread's copies landed and visible to wgmma (the async proxy)
__device__ __forceinline__ void tiles_ready() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// 64 rows from row0 of an (L, D) bf16 matrix with row stride ld into the
// swizzled tile at shared address dst (D / 64 boxes), zero past L
template <int D>
__device__ void load_tile_sw(uint32_t dst, const __nv_bfloat16* __restrict__ src,
                             int row0, int L, int64_t ld) {
  constexpr int CH = D / 8;
  for (int idx = threadIdx.x; idx < BT * CH; idx += THREADS) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = row0 + r < L;
    cp_async16(dst + (c >> 3) * SW_BOX + r * 128 + (((c & 7) ^ (r & 7)) << 4),
               ok ? src + (int64_t)(row0 + r) * ld + c * 8 : src, ok);
  }
}

// acc (64 x 64) = A B^T over D, A and B the 64 rows of two tiles, K-major
template <int D>
__device__ __forceinline__ void wg_abt(float* acc, uint32_t a, uint32_t b) {
  const uint64_t da = smem_desc(a), db = smem_desc(b);
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    const uint64_t off = (uint64_t)((kd >> 2) * (SW_BOX >> 4) + 2 * (kd & 3));
    wgmma_bf16<64>(acc, da + off, db + off, kd > 0);
  }
}

// acc (64 x 64) += X M: X (64 x 64) in registers as bf16 A fragments, M
// the 64 rows of one box of a tile, MN-major (16 rows a k-step, 2048 bytes)
__device__ __forceinline__ void wg_xm(float* acc, const uint32_t* xf,
                                      uint32_t box) {
  const uint64_t dm = smem_desc_mn(box, SW_BOX);
#pragma unroll
  for (int kc = 0; kc < BT / 16; ++kc)
    wgmma_rs_bf16_tb<64>(acc, xf + 4 * kc, dm + (uint64_t)(kc * (2048 >> 4)));
}

// accumulator element i of this thread: row 8 ((i >> 1) & 1) below its
// warp's first, column 8 (i >> 2) + 2 t + (i & 1)
__device__ __forceinline__ int acc_col(int i, int t) {
  return 8 * (i >> 2) + 2 * t + (i & 1);
}

__device__ __forceinline__ void pack_acc(const float* x, uint32_t* xf) {
#pragma unroll
  for (int i = 0; i < 16; ++i) xf[i] = pack_bf16(x[2 * i], x[2 * i + 1]);
}

// rows r0, r0 + 8 of a 64-column accumulator slice (columns c0 ..) times
// scale to out (row stride D) in bf16, rows < n_rows
template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, const float* x,
                                          int row, int n_rows, int c0,
                                          float scale, int t) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = row + 8 * ((i >> 1) & 1);
    if (r < n_rows)
      out[(int64_t)r * D + c0 + acc_col(i, t)] = __float2bfloat16(x[i] * scale);
  }
}

// the 1024-byte aligned start of the dynamic shared memory (the swizzle
// repeats every 1024 bytes)
__device__ __forceinline__ uint32_t smem_base(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return a + ((1024 - (a & 1023)) & 1023);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_pre_wgmma(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ dout, const Strides st,
                    float* __restrict__ lse, float* __restrict__ delta, int L,
                    float c) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int TILE = D / 64 * SW_BOX;
  const uint32_t sQ = smem_base(smem_raw), sK = sQ + TILE;
  const int q0 = blockIdx.x * BT, bh = blockIdx.y;
  const int64_t base = (int64_t)bh * L * D;
  const int t = threadIdx.x & 3, r0 = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);

  load_tile_sw<D>(sQ, q + base, q0, L, D);
  row_delta(dout, st, o, delta, bh, q0, L, D);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < L; k0 += BT) {
    load_tile_sw<D>(sK, k + base, k0, L, D);
    tiles_ready();
    float s[32];
    wgmma_fence();
    wg_abt<D>(s, sQ, sK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(s);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float x = k0 + acc_col(i, t) < L ? s[i] * c : -INFINITY;
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]));  // finite: key k0 < L
      l[r] *= exp2f(m[r] - mn);
      m[r] = mn;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) l[(i >> 1) & 1] += exp2f(s[i] - m[(i >> 1) & 1]);
    __syncthreads();  // the K tile is free
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float tot = quad_sum(l[r]);
    const int row = q0 + r0 + 8 * r;
    if (t == 0 && row < L) lse[(int64_t)bh * L + row] = m[r] + log2f(tot);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_wgmma(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout, const Strides st,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int L, float c,
                     float scale) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int TILE = D / 64 * SW_BOX;
  const uint32_t sK = smem_base(smem_raw), sV = sK + TILE, sQ = sV + TILE,
                 sO = sQ + TILE;
  float* lse_s = reinterpret_cast<float*>(smem_raw + (sO + TILE - smem_u32(smem_raw)));
  float* dl_s = lse_s + BT;
  const int kt0 = blockIdx.x * BT, bh = blockIdx.y, c0 = blockIdx.z * 64;
  const int64_t base = (int64_t)bh * L * D;
  const __nv_bfloat16* dob = dout + st.base(bh);
  const int t = threadIdx.x & 3, r0 = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);

  load_tile_sw<D>(sK, k + base, kt0, L, D);
  load_tile_sw<D>(sV, v + base, kt0, L, D);
  float dka[32], dva[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;
  for (int q0 = 0; q0 < L; q0 += BT) {
    load_tile_sw<D>(sQ, q + base, q0, L, D);
    load_tile_sw<D>(sO, dob, q0, L, st.sl);
    if (threadIdx.x < BT) {
      const int row = q0 + threadIdx.x;
      // rows past L: P = exp2(-inf) = 0 and delta 0, so they add nothing
      lse_s[threadIdx.x] = row < L ? lse[(int64_t)bh * L + row] : INFINITY;
      dl_s[threadIdx.x] = row < L ? delta[(int64_t)bh * L + row] : 0.f;
    }
    tiles_ready();
    float p[32], dp[32];
    uint32_t xf[16];
    wgmma_fence();
    wg_abt<D>(p, sK, sQ);                      // S^T = K Q^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(p);
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i] = exp2f(p[i] * c - lse_s[acc_col(i, t)]);
    pack_acc(p, xf);
    fence_regs<32>(dva);
    wgmma_fence();
    wg_xm(dva, xf, sO + (c0 / 64) * SW_BOX);  // dV += P^T dO
    wg_abt<D>(dp, sV, sO);                     // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(dva);
    fence_regs<32>(dp);
    fence_regs<16>(xf);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = p[i] * (dp[i] - dl_s[acc_col(i, t)]);
    pack_acc(dp, xf);
    fence_regs<32>(dka);
    wgmma_fence();
    wg_xm(dka, xf, sQ + (c0 / 64) * SW_BOX);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(dka);
    fence_regs<16>(xf);
    __syncthreads();  // the Q and dO tiles are free
  }
  store_acc<D>(dk + base, dka, kt0 + r0, L, c0, scale, t);
  store_acc<D>(dv + base, dva, kt0 + r0, L, c0, 1.f, t);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_wgmma(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout, const Strides st,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int L, float c,
                   float scale) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int TILE = D / 64 * SW_BOX;
  const uint32_t sQ = smem_base(smem_raw), sO = sQ + TILE, sK = sO + TILE,
                 sV = sK + TILE;
  const int q0 = blockIdx.x * BT, bh = blockIdx.y, c0 = blockIdx.z * 64;
  const int64_t base = (int64_t)bh * L * D;
  const int t = threadIdx.x & 3, r0 = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);

  load_tile_sw<D>(sQ, q + base, q0, L, D);
  load_tile_sw<D>(sO, dout + st.base(bh), q0, L, st.sl);
  float lr[2], dl[2], dqa[32];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    lr[r] = row < L ? lse[(int64_t)bh * L + row] : 0.f;
    dl[r] = row < L ? delta[(int64_t)bh * L + row] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) dqa[i] = 0.f;
  for (int k0 = 0; k0 < L; k0 += BT) {
    load_tile_sw<D>(sK, k + base, k0, L, D);
    load_tile_sw<D>(sV, v + base, k0, L, D);
    tiles_ready();
    float p[32], dp[32];
    uint32_t xf[16];
    wgmma_fence();
    wg_abt<D>(p, sQ, sK);    // S = Q K^T
    wg_abt<D>(dp, sO, sV);   // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(p);
    fence_regs<32>(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float pe = k0 + acc_col(i, t) < L ? exp2f(p[i] * c - lr[r]) : 0.f;
      dp[i] = pe * (dp[i] - dl[r]);
    }
    pack_acc(dp, xf);
    fence_regs<32>(dqa);
    wgmma_fence();
    wg_xm(dqa, xf, sK + (c0 / 64) * SW_BOX);  // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(dqa);
    fence_regs<16>(xf);
    __syncthreads();  // the K and V tiles are free
  }
  store_acc<D>(dq + base, dqa, q0 + r0, L, c0, scale, t);
}

template <typename K>
cudaError_t smem_attr(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int DP>
int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                const __nv_bfloat16* v, const __nv_bfloat16* o,
                const __nv_bfloat16* dout, const Strides st,
                __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
                float* lse, float* delta, int BH, int L, int D, int vec,
                int vec_do, float c, float scale, cudaStream_t s) {
  constexpr int NC = DP < CHUNK ? DP : CHUNK;
  const int tile_bytes = BT * (DP + 8) * (int)sizeof(__nv_bfloat16);
  const int n_t = (L + BT - 1) / BT;
  const dim3 grid(n_t, BH), grid_c(n_t, BH, (D + NC - 1) / NC);
  cudaError_t e;
  if ((e = smem_attr(flash_bwd_pre_bf16<DP>, 2 * tile_bytes)) != cudaSuccess ||
      (e = smem_attr(flash_bwd_dkdv_bf16<DP>, 4 * tile_bytes + 2 * BT * 4)) !=
          cudaSuccess ||
      (e = smem_attr(flash_bwd_dq_bf16<DP>, 4 * tile_bytes)) != cudaSuccess)
    return e;
  flash_bwd_pre_bf16<DP><<<grid, THREADS, 2 * tile_bytes, s>>>(
      q, k, o, dout, st, lse, delta, L, D, c, vec);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  flash_bwd_dkdv_bf16<DP><<<grid_c, THREADS, 4 * tile_bytes + 2 * BT * 4, s>>>(
      q, k, v, dout, st, lse, delta, dk, dv, L, D, c, scale, vec, vec_do);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  flash_bwd_dq_bf16<DP><<<grid_c, THREADS, 4 * tile_bytes, s>>>(
      q, k, v, dout, st, lse, delta, dq, L, D, c, scale, vec, vec_do);
  return cudaGetLastError();
}

template <int D>
int launch_wgmma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                 const __nv_bfloat16* v, const __nv_bfloat16* o,
                 const __nv_bfloat16* dout, const Strides st,
                 __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
                 float* lse, float* delta, int BH, int L, float c, float scale,
                 cudaStream_t s) {
  constexpr int TILE = D / 64 * SW_BOX;
  const int n_t = (L + BT - 1) / BT;
  const dim3 grid(n_t, BH), grid_c(n_t, BH, D / 64);
  // + 1024: the tiles start on a 1024-byte boundary
  const int pre_bytes = 2 * TILE + 1024, dkdv_bytes = 4 * TILE + 2 * BT * 4 + 1024;
  const int dq_bytes = 4 * TILE + 1024;
  cudaError_t e;
  if ((e = smem_attr(flash_bwd_pre_wgmma<D>, pre_bytes)) != cudaSuccess ||
      (e = smem_attr(flash_bwd_dkdv_wgmma<D>, dkdv_bytes)) != cudaSuccess ||
      (e = smem_attr(flash_bwd_dq_wgmma<D>, dq_bytes)) != cudaSuccess)
    return e;
  flash_bwd_pre_wgmma<D><<<grid, THREADS, pre_bytes, s>>>(q, k, o, dout, st,
                                                          lse, delta, L, c);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  flash_bwd_dkdv_wgmma<D><<<grid_c, THREADS, dkdv_bytes, s>>>(
      q, k, v, dout, st, lse, delta, dk, dv, L, c, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  flash_bwd_dq_wgmma<D><<<grid_c, THREADS, dq_bytes, s>>>(
      q, k, v, dout, st, lse, delta, dq, L, c, scale);
  return cudaGetLastError();
}

int launch_f32(const float* q, const float* k, const float* v,
               const float* o, const float* dout, const Strides st,
               float* dq, float* dk, float* dv, float* lse, float* delta,
               int BH, int L, int D, float c, float scale, cudaStream_t s) {
  const int chunk_bytes = CHUNK * TS * (int)sizeof(float);
  const int n_t = (L + BT - 1) / BT;
  const dim3 grid(n_t, BH), grid_c(n_t, BH, (D + CHUNK - 1) / CHUNK);
  const int dkdv_bytes = 4 * chunk_bytes + 2 * BT * 4;
  cudaError_t e;
  if ((e = smem_attr(flash_bwd_pre_f32, 2 * chunk_bytes)) != cudaSuccess ||
      (e = smem_attr(flash_bwd_dkdv_f32, dkdv_bytes)) != cudaSuccess ||
      (e = smem_attr(flash_bwd_dq_f32, 3 * chunk_bytes)) != cudaSuccess)
    return e;
  flash_bwd_pre_f32<<<grid, THREADS, 2 * chunk_bytes, s>>>(
      q, k, o, dout, st, lse, delta, L, D, c);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  flash_bwd_dkdv_f32<<<grid_c, THREADS, dkdv_bytes, s>>>(
      q, k, v, dout, st, lse, delta, dk, dv, L, D, c, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  flash_bwd_dq_f32<<<grid_c, THREADS, 3 * chunk_bytes, s>>>(
      q, k, v, dout, st, lse, delta, dq, L, D, c, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* flash_attention_backward_error_string(int code) {
  return error_string(code);
}

// q, k, v, o, dq, dk, dv (B*H, L, D), contiguous; dout (B, H, L, D) with
// element (b, h, l, d) at b do_sb + h do_sh + l do_sl + d; f32 for route 0
// (FMA), bf16 for route 1 (mma.sync) and route 2 (wgmma: D 64 or 128, q, k,
// v and dout 16-byte aligned, dout's strides multiples of 8).  Scratch lse
// and delta (B*H, L) f32.  All on the current device.  Launches on
// `stream`, does not synchronise, returns the first launch error (0 on
// success).
int flash_attention_backward(const void* dout, const void* q, const void* k,
                             const void* v, const void* o, void* dq, void* dk,
                             void* dv, float* lse, float* delta, int B, int H,
                             int L, int D, long long do_sb, long long do_sh,
                             long long do_sl, int route, void* stream) {
  const int BH = B * H;
  if (B < 1 || H < 1 || BH > 65535 || L < 1 || D < 1 || D > MAX_D)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st{H, do_sb, do_sh, do_sl};
  const float scale = 1.f / sqrtf((float)D);
  const float c = 1.4426950408889634f * scale;
  if (route == ROUTE_FMA)
    return launch_f32(static_cast<const float*>(q),
                      static_cast<const float*>(k),
                      static_cast<const float*>(v),
                      static_cast<const float*>(o),
                      static_cast<const float*>(dout), st,
                      static_cast<float*>(dq), static_cast<float*>(dk),
                      static_cast<float*>(dv), lse, delta, BH, L, D, c, scale,
                      s);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* ob = static_cast<const __nv_bfloat16*>(o);
  const auto* db = static_cast<const __nv_bfloat16*>(dout);
  auto* dqb = static_cast<__nv_bfloat16*>(dq);
  auto* dkb = static_cast<__nv_bfloat16*>(dk);
  auto* dvb = static_cast<__nv_bfloat16*>(dv);
  const int vec = D % 8 == 0 &&
                  ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  const int vec_do = D % 8 == 0 && (uintptr_t)dout % 16 == 0 &&
                     do_sl % 8 == 0 && do_sh % 8 == 0 && do_sb % 8 == 0;
  if (route == ROUTE_WGMMA) {
    if (!vec || !vec_do) return cudaErrorMisalignedAddress;
    if (D == 64)
      return launch_wgmma<64>(qb, kb, vb, ob, db, st, dqb, dkb, dvb, lse,
                              delta, BH, L, c, scale, s);
    if (D == 128)
      return launch_wgmma<128>(qb, kb, vb, ob, db, st, dqb, dkb, dvb, lse,
                               delta, BH, L, c, scale, s);
    return cudaErrorInvalidValue;
  }
  if (route != ROUTE_MMA_SYNC) return cudaErrorInvalidValue;
#define K2B_LAUNCH(DP)                                                      \
  return launch_bf16<DP>(qb, kb, vb, ob, db, st, dqb, dkb, dvb, lse, delta, \
                         BH, L, D, vec, vec_do, c, scale, s)
  if (D <= 32) K2B_LAUNCH(32);
  if (D <= 64) K2B_LAUNCH(64);
  if (D <= 128) K2B_LAUNCH(128);
  K2B_LAUNCH(256);
#undef K2B_LAUNCH
}

}  // extern "C"
