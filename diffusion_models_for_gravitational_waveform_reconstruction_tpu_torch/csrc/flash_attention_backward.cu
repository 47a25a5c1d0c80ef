// Backward of flash attention for Hopper (sm_90a): the gradients (dq, dk,
// dv) of non-causal softmax(Q K^T / sqrt(D)) V on (B*H, L, D) tensors in f32
// or bf16, given dout and the forward's output, in the input dtype.
//
// The backward of K2, the Pallas TPU kernel
// diffusion_models_for_gravitational_waveform_reconstruction_tpu/ops/pallas/attention.py:70.
// The JAX package has no kernel for it: that Pallas kernel is forward-only,
// and its trainer differentiates the plain expression
// flash_attention_reference (attention.py:27-33) with XLA's autodiff.  This
// kernel computes the gradients of the port's plain backward
// (ops/kernels/flash_attention.py::flash_attention_backward),
// FlashAttention-2 style, with nothing of size L x L in device memory, in
// three kernels:
//   pre   - per query row, delta = rowsum(dO * O) in f32 and the log-sum-exp
//           of the scaled scores (log2 units), recomputed by a
//           statistics-only pass over the keys (the forward op cannot hand
//           it over: exported artifacts record its schema), into a scratch
//           padded to LP = L rounded up to 128 (lse +inf, delta 0 past L);
//   dkdv  - per (b*h, tile of keys), walking the query tiles: S^T = K Q^T,
//           P^T = exp2(S^T c - lse), dV += P^T dO, dP^T = V dO^T,
//           dS^T = P^T (dP^T - delta), dK += dS^T Q;
//   dq    - per (b*h, tile of queries), walking the key tiles: the same P
//           and dS, dQ += dS K;
// then dK and dQ times 1 / sqrt(D).  Each output element is summed by one
// thread in a fixed order: no float atomics, two calls give the same bits.
// P and dS are rounded to bf16 as the A operands of dV, dK and dQ in bf16
// (the plain backward rounds P for dV and keeps dS in f32).  dout may be
// strided (the U-Net hands it transposed): element (b, h, l, d) at b sb +
// h sh + l sl + d.  Routes:
//   wgmma (bf16, D 64 or 128, 16-byte aligned rows, dout's strides
//     multiples of 8): the three kernels on one pipeline, below: persistent
//     CTAs, a producer warpgroup issuing TMA loads into a ring of 4-6
//     stages, two consumer warpgroups of 64 rows each (128-row tiles) that
//     take turns on the tensor cores, P and dS as register operands; the
//     training route (attn16k's D is 64);
//   mma_sync (other bf16): four warps, 64-row tiles, mma.sync m16n8k16, the
//     M-major B operands (dO and Q for dV and dK, K for dQ) through
//     ldmatrix.trans;
//   fma (f32, no TF32): D <= 64 on 128-row resident and 64-row walked tiles
//     double-buffered through cp.async, all of D kept in shared memory,
//     8 x 4 register tiles of 256 threads; D > 64 on 64-row tiles with D
//     in chunks of 64.
//
// What bounds it on the H100.  Five products of 2 B H L^2 D FLOPs (S, dP,
// dV, dK, dQ) against q, k, v, o, dout and the three outputs read or
// written once: at attn16k's (16, 4, 4096, 64) 687 GFLOP for 0.2 GB, 0.695
// ms at 989 TFLOP/s: operations.  The three kernels run 8 (S three times,
// dP twice), 1.1 ms at that rate, and three exp2 passes of B H L^2 =
// 1.07 G exponentials, each about 0.3 ms on the SFUs (16 a clock per SM),
// which the pipeline overlaps with the products: each consumer warpgroup
// issues tile j's S and dP before tile j - 1's dV and dK (or dQ), so tile
// j's exponentials run while those are on the tensor cores, and the two
// warpgroups issue in turns, one's products running while the other
// computes.  Measured on an H100, the exponential and dS work still adds
// about half of the products' time: it overlaps them only in part.  In f32
// the same eight products run on the FMA units (67 TFLOP/s): 4.1 ms at
// (4, 4, 4096, 64).
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
// f32 with D > 64 on the FMA units.  Thread (tx, ty) of 8 x 16 owns rows
// ty * 4 + i (i < 4) of a 64-row tile and columns tx + 8 j (j < 8) of the
// other tile or of the CTA's 64 output columns; D is contracted in chunks
// of 64 reloaded for each product.

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
// f32 with D <= 64 on the FMA units (no TF32): 256 threads, a resident tile
// of 128 rows (the CTA's keys, or its queries) and a walked tile of 64 rows
// double-buffered through cp.async, every column of D (zero past D) in
// shared memory as [row][FS] floats.  Thread (tx, ty) of 16 x 16 owns
// resident rows ty * 4 + i and 64 + ty * 4 + i (i < 4) and walked rows
// tx + 16 j (j < 4) of a score tile, and columns 4 tx .. 4 tx + 3 of an
// output: every operand read is a float4, 12 of them per 128 FMAs, and the
// 16-byte reads of a warp meet no bank conflict (FS = 68).

constexpr int FR = 128, FW = 64, FS = 68, FTHREADS = 256;
constexpr int F_ROWS_BYTES = FR * FS * 4, F_WALK_BYTES = FW * FS * 4;

__device__ __forceinline__ int f_row(int i, int ty) {
  return (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
}

// n rows from row0 of an (L, D) f32 matrix with row stride ld into the
// [n][FS] tile at shared address dst, zero past L and past D (columns up to
// 64); 16-byte copies when vec (D % 4 == 0, 16-byte aligned rows).
template <int N>
__device__ __forceinline__ void f_load_rows(uint32_t dst,
                                            const float* __restrict__ src,
                                            int row0, int L, int D,
                                            int64_t ld, int vec) {
  if (vec) {
    for (int idx = threadIdx.x; idx < N * 16; idx += FTHREADS) {
      const int r = idx >> 4, c = (idx & 15) * 4;
      const bool ok = row0 + r < L && c < D;
      cp_async16(dst + (r * FS + c) * 4,
                 ok ? src + (int64_t)(row0 + r) * ld + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < N * 64; idx += FTHREADS) {
      const int r = idx >> 6, c = idx & 63;
      const bool ok = row0 + r < L && c < D;
      cp_async4(dst + (r * FS + c) * 4,
                ok ? src + (int64_t)(row0 + r) * ld + c : src, ok);
    }
  }
}

// s[i][j] = sum over d < 64 of R[f_row(i)][d] W[tx + 16 j][d]
__device__ __forceinline__ void f_scores(float (*s)[4], const float* R,
                                         const float* W, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < 64; d += 4) {
    float4 b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(W + (tx + 16 * j) * FS + d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(R + f_row(i, ty) * FS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a.x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a.y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a.z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a.w, b[j].w, s[i][j]);
      }
    }
  }
}

// acc[i][c] += sum over k < 64 of A[f_row(i)][k] M[k][4 tx + c]
__device__ __forceinline__ void f_out(float (*acc)[4], const float* A,
                                      const float* M, int tx, int ty) {
#pragma unroll 2
  for (int k = 0; k < 64; k += 4) {
    float4 m[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      m[kk] = *reinterpret_cast<const float4*>(M + (k + kk) * FS + 4 * tx);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(A + f_row(i, ty) * FS + k);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc[i][0] = fmaf(av[kk], m[kk].x, acc[i][0]);
        acc[i][1] = fmaf(av[kk], m[kk].y, acc[i][1]);
        acc[i][2] = fmaf(av[kk], m[kk].z, acc[i][2]);
        acc[i][3] = fmaf(av[kk], m[kk].w, acc[i][3]);
      }
    }
  }
}

// rows f_row(i) + row0 of a thread's 8 x 4 output block times `scale` to
// out (row stride D), rows < L, columns < D
__device__ __forceinline__ void f_store(float* __restrict__ out,
                                        float (*acc)[4], int row0, int L,
                                        int D, float scale, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + f_row(i, ty);
    if (row >= L) continue;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      if (4 * tx + cc < D) out[(int64_t)row * D + 4 * tx + cc] = acc[i][cc] * scale;
  }
}

// delta of rows q0 .. q0 + 127 (two threads a row) and the log-sum-exp of
// their scores over every key (log2 units), both into the (B*H, LP)
// scratch; rows L .. LP - 1 get lse +inf and delta 0, so P is 0 there.
__global__ void __launch_bounds__(FTHREADS)
flash_bwd_pre_f32w(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ o, const float* __restrict__ dout,
                   const Strides st, float* __restrict__ lse,
                   float* __restrict__ delta, int L, int LP, int D, float c,
                   int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + FR * FS;  // two stages of FW rows
  const uint32_t sQ = smem_u32(Qs), sK = smem_u32(Ks);
  const int q0 = blockIdx.x * FR, bh = blockIdx.y;
  const int64_t base = (int64_t)bh * L * D;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n_kt = (L + FW - 1) / FW;

  f_load_rows<FR>(sQ, q + base, q0, L, D, D, vec);
  f_load_rows<FW>(sK, k + base, 0, L, D, D, vec);
  cp_async_commit();
  {  // delta: two threads a row
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, row = q0 + r;
    float s = 0.f;
    if (row < L) {
      const float* dr = dout + st.base(bh) + (int64_t)row * st.sl;
      const float* orow = o + base + (int64_t)row * D;
      for (int d = half; d < D; d += 2) s = fmaf(dr[d], orow[d], s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (half == 0) delta[(int64_t)bh * LP + row] = row < L ? s : 0.f;
  }
  float m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) {
      f_load_rows<FW>(sK + ((j + 1) & 1) * F_WALK_BYTES, k + base,
                      (j + 1) * FW, L, D, D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[8][4];
    f_scores(s, Qs, Ks + (j & 1) * FW * FS, tx, ty);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float x = j * FW + tx + 16 * jj < L ? s[i][jj] * c : -INFINITY;
        s[i][jj] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);  // finite: key j * FW < L
      l[i] *= exp2f(m[i] - mn);
      m[i] = mn;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) l[i] += exp2f(s[i][jj] - mn);
    }
    __syncthreads();  // the stage is free
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      li += __shfl_xor_sync(0xffffffffu, li, off);
    const int row = q0 + f_row(i, ty);
    if (tx == 0) lse[(int64_t)bh * LP + row] = row < L ? m[i] + log2f(li) : INFINITY;
  }
}

// One CTA per (b*h, 128 keys): walks the query tiles, S^T and dP^T from
// the resident K and V, P^T and dS^T through shared memory into dV and dK.
__global__ void __launch_bounds__(FTHREADS, 1)
flash_bwd_dkdv_f32w(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout, const Strides st,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int L, int LP, int D, float c,
                    float scale, int vec, int vec_do) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + FR * FS;
  float* Qs = Vs + FR * FS;   // two stages
  float* Os = Qs + 2 * FW * FS;  // dO, two stages
  float* PT = Os + 2 * FW * FS;  // [key][query]
  float* ST = PT + FR * FS;      // dS^T, [key][query]
  float* LD = ST + FR * FS;      // two stages of lse[64], delta[64]
  const int kt0 = blockIdx.x * FR, bh = blockIdx.y;
  const int64_t base = (int64_t)bh * L * D;
  const float* dob = dout + st.base(bh);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n_qt = (L + FW - 1) / FW;

  auto load_tile = [&](int j) {
    const int s = j & 1, q0 = j * FW;
    f_load_rows<FW>(smem_u32(Qs + s * FW * FS), q + base, q0, L, D, D, vec);
    f_load_rows<FW>(smem_u32(Os + s * FW * FS), dob, q0, L, D, st.sl, vec_do);
    if (threadIdx.x < 32) {  // lse, delta: rows q0 .. q0 + 63 < LP
      const int which = threadIdx.x >> 4, ch = threadIdx.x & 15;
      const float* src = (which ? delta : lse) + (int64_t)bh * LP + q0 + 4 * ch;
      cp_async16(smem_u32(LD + s * 2 * FW + which * FW + 4 * ch), src, true);
    }
    cp_async_commit();
  };
  f_load_rows<FR>(smem_u32(Ks), k + base, kt0, L, D, D, vec);
  f_load_rows<FR>(smem_u32(Vs), v + base, kt0, L, D, D, vec);
  load_tile(0);
  float dka[8][4], dva[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int j = 0; j < n_qt; ++j) {
    if (j + 1 < n_qt) {
      load_tile(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Qj = Qs + (j & 1) * FW * FS;
    const float* Oj = Os + (j & 1) * FW * FS;
    const float* lj = LD + (j & 1) * 2 * FW;
    {
      float s[8][4], dp[8][4];
      f_scores(s, Ks, Qj, tx, ty);   // S^T = K Q^T
      f_scores(dp, Vs, Oj, tx, ty);  // dP^T = V dO^T
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int qq = tx + 16 * jj;
        const float ls = lj[qq], dl = lj[FW + qq];  // past L: +inf, 0
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float p = exp2f(s[i][jj] * c - ls);
          PT[f_row(i, ty) * FS + qq] = p;
          ST[f_row(i, ty) * FS + qq] = p * (dp[i][jj] - dl);
        }
      }
    }
    __syncthreads();
    f_out(dva, PT, Oj, tx, ty);  // dV += P^T dO
    f_out(dka, ST, Qj, tx, ty);  // dK += dS^T Q
    __syncthreads();
  }
  f_store(dk + base, dka, kt0, L, D, scale, tx, ty);
  f_store(dv + base, dva, kt0, L, D, 1.f, tx, ty);
}

// One CTA per (b*h, 128 queries): walks the key tiles, S and dP from the
// resident Q and dO, dS through shared memory into dQ.
__global__ void __launch_bounds__(FTHREADS, 1)
flash_bwd_dq_f32w(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const Strides st, const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int L, int LP, int D, float c, float scale, int vec,
                  int vec_do) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Os = Qs + FR * FS;
  float* Ks = Os + FR * FS;      // two stages
  float* Vs = Ks + 2 * FW * FS;  // two stages
  float* DS = Vs + 2 * FW * FS;  // [query][key]
  const int q0 = blockIdx.x * FR, bh = blockIdx.y;
  const int64_t base = (int64_t)bh * L * D;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n_kt = (L + FW - 1) / FW;

  auto load_tile = [&](int j) {
    const int s = j & 1;
    f_load_rows<FW>(smem_u32(Ks + s * FW * FS), k + base, j * FW, L, D, D, vec);
    f_load_rows<FW>(smem_u32(Vs + s * FW * FS), v + base, j * FW, L, D, D, vec);
    cp_async_commit();
  };
  f_load_rows<FR>(smem_u32(Qs), q + base, q0, L, D, D, vec);
  f_load_rows<FR>(smem_u32(Os), dout + st.base(bh), q0, L, D, st.sl, vec_do);
  load_tile(0);
  float lr[8], dl[8], dqa[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t r = (int64_t)bh * LP + q0 + f_row(i, ty);  // < LP
    lr[i] = lse[r];
    dl[i] = delta[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) dqa[i][j] = 0.f;
  }
  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) {
      load_tile(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kj = Ks + (j & 1) * FW * FS;
    const float* Vj = Vs + (j & 1) * FW * FS;
    {
      float s[8][4], dp[8][4];
      f_scores(s, Qs, Kj, tx, ty);   // S = Q K^T
      f_scores(dp, Os, Vj, tx, ty);  // dP = dO V^T
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kk = tx + 16 * jj;
        const bool ok = j * FW + kk < L;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float p = ok ? exp2f(s[i][jj] * c - lr[i]) : 0.f;
          DS[f_row(i, ty) * FS + kk] = p * (dp[i][jj] - dl[i]);
        }
      }
    }
    __syncthreads();
    f_out(dqa, DS, Kj, tx, ty);  // dQ += dS K
    __syncthreads();
  }
  f_store(dq + base, dqa, q0, L, D, scale, tx, ty);
}

// ---------------------------------------------------------------------------
// bf16 on wgmma (D 64 or 128; q, k, v and dout on 16-byte aligned rows,
// dout's strides multiples of 8 elements), FlashAttention-3's shape.  Each
// kernel runs a persistent grid of one 384-thread CTA an SM walking work
// items (a 128-row tile of one head, and 64 columns of D for dK / dV and
// dQ): warpgroup 2 is the producer (setmaxnreg lowers it to 24 registers;
// one thread issues every load), warpgroups 0 and 1 consume (240
// registers) and own 64 rows each of the item's 128.  The item's own tile
// (128 rows of q, or of k and v, or of q and dout) is loaded once, mostly
// into registers as wgmma A operands, and released, so the next item's
// loads while this one runs; the walked tiles come through a ring of
// stages under full / empty mbarriers that runs on across items, by TMA:
// tensor maps over (D, L, B*H) for q, k and v and over dout's four dims by
// its own strides (no copy of the U-Net's transposed dout), boxes of 64
// columns x 64 rows, 128B-swizzled, so rows past L come back zero and no
// tile reads the next head; the lse and delta rows of a query tile come by
// a bulk copy from the padded scratch.  A tile sits in shared memory as
// [64-column box][64-row block], 8 KB each: 64 rows of a column box are a
// K-major operand (the contraction over D), the rows of one box an MN-major
// one (the contraction over rows; the descriptor's transpose bit).  Within
// a warpgroup the next tile's S and dP are issued before the previous
// tile's register-A products (dV and dK, or dQ), so that its exp2 and dS
// run while those are on the tensor cores; the two warpgroups issue in
// turns (named barriers 1 and 2).  On an H100 the turns gave 6% at
// (16, 4, 4096, 64), the persistent grid 4-5%; deeper rings, exponentials
// in half precision or on the FMA pipe, and a lazily rebased running max
// gave nothing.

constexpr int WG_THREADS = 384, PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int BOX = 64 * 128;  // 64 rows of one 64-column box, bytes

template <int D>
struct TmaCfg {
  static constexpr int NB = D / 64;        // column boxes
  static constexpr int T64 = NB * BOX;     // a 64-row tile
  static constexpr int T128 = 2 * T64;     // a 128-row tile
  static constexpr int STAGES = D == 64 ? 6 : 4;  // at most 196 KB
  static constexpr int BARS = 8 * (2 * STAGES + 2);
  // pre: Q (128 rows) and a ring of K tiles of 128 rows
  static constexpr int PRE = 1024 + T128 + STAGES * T128 + BARS;
  // dK / dV: K and V (128 rows each), a ring of Q and dO tiles of 64 rows
  // and of their lse and delta rows (512 bytes)
  static constexpr int DKDV = 1024 + 2 * T128 + STAGES * (2 * T64 + 512) + BARS;
  // dQ: Q and dO (128 rows each), a ring of K and V tiles of 64 rows
  static constexpr int DQ = 1024 + 2 * T128 + STAGES * 2 * T64 + BARS;
};

// The two consumer warpgroups take turns to issue their products (named
// barriers 1 and 2, one a warpgroup): while one warpgroup's products run,
// the other computes its exponentials.
struct Turns {
  int wg;
  __device__ void start() const {  // warpgroup 0 goes first
    if (wg == 1) named_arrive(1, 256);
  }
  __device__ void mine() const { named_barrier(1 + wg, 256); }
  // the other warpgroup's turn; the last turn of warpgroup 1 has no taker
  __device__ void pass(bool last) const {
    if (!(last && wg == 1)) named_arrive(2 - wg, 256);
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the 1024-byte aligned start of the dynamic shared memory (the swizzle
// repeats every 1024 bytes)
__device__ __forceinline__ uint32_t smem_base(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return a + ((1024 - (a & 1023)) & 1023);
}

// rows row0 .. row0 + 64 * RB - 1 of head bh of a (D, L, B*H) map into the
// tile at dst ([box][row block])
template <int D, int RB>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* m,
                                         uint32_t bar, int row0, int bh) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb)
#pragma unroll
    for (int rb = 0; rb < RB; ++rb)
      tma_load_3d(dst + (cb * RB + rb) * BOX, m, bar, 64 * cb, row0 + 64 * rb,
                  bh);
}

// the same from dout's 4-D map, dims (D, L, H, B), or (D, H, L, B) when
// `hl` (the order of increasing strides)
template <int D, int RB>
__device__ __forceinline__ void tma_tile_do(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int row0, int bh,
                                            int H, int hl) {
  const int b = bh / H, h = bh % H;
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb)
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
      const uint32_t d = dst + (cb * RB + rb) * BOX;
      if (hl)
        tma_load_4d(d, m, bar, 64 * cb, h, row0 + 64 * rb, b);
      else
        tma_load_4d(d, m, bar, 64 * cb, row0 + 64 * rb, h, b);
    }
}

// acc (64 x N) = A B^T over D, both K-major: A 64 rows at a, B N rows at b;
// a_box / b_box: bytes from one column box to the next
template <int D, int N>
__device__ __forceinline__ void wg_ss(float* acc, uint32_t a, int a_box,
                                      uint32_t b, int b_box) {
  const uint64_t da = smem_desc(a), db = smem_desc(b);
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd)
    wgmma_bf16<N>(acc, da + (uint64_t)(((kd >> 2) * a_box) >> 4) + 2 * (kd & 3),
                  db + (uint64_t)(((kd >> 2) * b_box) >> 4) + 2 * (kd & 3),
                  kd > 0);
}

// acc (64 x N) = A B^T over D: A 64 rows as register fragments
// (load_a_frags), B N rows K-major at b, its column boxes b_box bytes apart
template <int D, int N>
__device__ __forceinline__ void wg_rs_k(float* acc, const uint32_t* af,
                                        uint32_t b, int b_box) {
  const uint64_t db = smem_desc(b);
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd)
    wgmma_rs_bf16_kb<N>(acc, af + 4 * kd,
                        db + (uint64_t)(((kd >> 2) * b_box) >> 4) + 2 * (kd & 3),
                        kd > 0);
}

// acc (64 x 64) += X M: X (64 x 64) in registers as bf16 A fragments, M the
// 64 rows of one column box, MN-major (16 rows a k-step, 2048 bytes)
__device__ __forceinline__ void wg_rs(float* acc, const uint32_t* xf,
                                      uint32_t m) {
  const uint64_t dm = smem_desc_mn(m, BOX);
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
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

// rows row, row + 8 of a 64-column accumulator times scale to out (row
// stride D) from column c0 in bf16, rows < L
template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, const float* x,
                                          int row, int L, int c0, float scale,
                                          int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= L) continue;
    __nv_bfloat16* o = out + (int64_t)(row + 8 * r) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(o + 8 * n) =
          pack_bf16(x[4 * n + 2 * r] * scale, x[4 * n + 2 * r + 1] * scale);
  }
}

// A ring of ST stages under full[s] / empty[s] mbarriers, then the two of
// the CTA's own tile (own_full, own_empty).  The kernels are persistent:
// a CTA walks work items blockIdx.x, blockIdx.x + gridDim.x, ...; the ring
// runs on across items (t counts its tiles), and the next item's own tile
// is loaded once the consumers have released the current one.
template <int ST>
struct Ring {
  uint32_t bar;
  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < ST; ++s) {
        mbar_init(bar + 8 * s, 1);
        mbar_init(bar + 8 * (ST + s), 8);  // the 8 consumer warps
      }
      mbar_init(own_full(), 1);
      mbar_init(own_empty(), 8);
      mbar_init_fence();
    }
    __syncthreads();
  }
  __device__ uint32_t full(int t) const { return bar + 8 * (t % ST); }
  __device__ uint32_t empty(int t) const { return bar + 8 * (ST + t % ST); }
  __device__ uint32_t own_full() const { return bar + 16 * ST; }
  __device__ uint32_t own_empty() const { return bar + 16 * ST + 8; }
  // producer: wait until stage t's previous use is released
  __device__ void acquire(int t) const {
    mbar_wait(empty(t), ((t / ST) & 1) ^ 1);
  }
  __device__ void wait_full(int t) const { mbar_wait(full(t), (t / ST) & 1); }
  __device__ void release(int t, int lane) const {
    if (lane == 0) mbar_arrive(empty(t));
  }
  // the own tile of the CTA's it-th item
  __device__ void own_acquire(int it) const {
    mbar_wait(own_empty(), (it & 1) ^ 1);
  }
  __device__ void own_wait(int it) const { mbar_wait(own_full(), it & 1); }
  __device__ void own_release(int lane) const {
    if (lane == 0) mbar_arrive(own_empty());
  }
};

// Work item i of n_t 128-row tiles and nz 64-column chunks a head: chunk i
// % nz, tile (i / nz) % n_t, head i / (nz n_t); one head's items are
// consecutive, so the CTAs working at once share its tiles in L2.
struct Item {
  int bh, row0, c0;
  __device__ Item(int i, int n_t, int nz)
      : bh(i / nz / n_t), row0((i / nz % n_t) * 128), c0(i % nz * 64) {}
};

// LSE pass: one item per (b*h, 128 queries); S = Q K^T on wgmma m64n128
// with Q as register operands against key tiles of 128, online max and sum
// in log2 units; delta = rowsum(dO O) while the item's tiles load.  Rows L
// .. LP - 1 get lse +inf and delta 0.
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_pre_tma(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __nv_bfloat16* __restrict__ o,
                  const __nv_bfloat16* __restrict__ dout, const Strides st,
                  float* __restrict__ lse, float* __restrict__ delta, int L,
                  int LP, float c, int n_items) {
  using Cfg = TmaCfg<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = smem_base(smem_raw), sK = sQ + Cfg::T128;
  const Ring<Cfg::STAGES> ring{sK + Cfg::STAGES * Cfg::T128};
  const int n_kt = (L + 127) / 128;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ring.init();

  if (warp >= 8) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 8 && lane == 0) {
      int t = 0;
      for (int i = blockIdx.x, it = 0; i < n_items; i += gridDim.x, ++it) {
        const Item item(i, n_kt, 1);
        ring.own_acquire(it);
        mbar_expect_tx(ring.own_full(), Cfg::T128);
        tma_tile<D, 2>(sQ, &tm_q, ring.own_full(), item.row0, item.bh);
        for (int j = 0; j < n_kt; ++j, ++t) {
          ring.acquire(t);
          mbar_expect_tx(ring.full(t), Cfg::T128);
          tma_tile<D, 2>(sK + (t % Cfg::STAGES) * Cfg::T128, &tm_k,
                         ring.full(t), 128 * j, item.bh);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  uint32_t qf[D / 4];  // this warpgroup's 64 Q rows as register A operands
  float sa[64], sb[64];
  // m: the running row max of the scores times c (log2 units)
  float m[2], l[2];
  int t0 = 0;  // the item's first K tile in the ring
  auto issue = [&](float* acc, int j) {
    ring.wait_full(t0 + j);
    wgmma_fence();
    wg_rs_k<D, 128>(acc, qf, sK + ((t0 + j) % Cfg::STAGES) * Cfg::T128,
                    2 * BOX);
    wgmma_commit();
  };
  auto absorb = [&](float* sc, int j) {  // the online max and sum of tile j
    const int n_valid = L - 128 * j;
    if (n_valid < 128) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (acc_col(i, t) >= n_valid) sc[i] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 64; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // finite: key 128 j < L; c > 0
      const float mn = fmaxf(m[r], quad_max(mx[r]) * c);
      l[r] *= ex2(m[r] - mn);
      m[r] = mn;
    }
#pragma unroll
    for (int i = 0; i < 64; i += 2) {  // i, i + 1: one row
      const int r = (i >> 1) & 1;
      sum[r] += ex2(fmaf(sc[i], c, -m[r])) + ex2(fmaf(sc[i + 1], c, -m[r]));
    }
    l[0] += sum[0];
    l[1] += sum[1];
  };
  for (int i = blockIdx.x, it = 0; i < n_items;
       i += gridDim.x, ++it, t0 += n_kt) {
    const Item item(i, n_kt, 1);
    const int q0 = item.row0, bh = item.bh;
    {  // delta: two threads a row, D / 2 columns each
      const int r = threadIdx.x >> 1, half = threadIdx.x & 1, row = q0 + r;
      float s = 0.f;
      if (row < L) {
        const uint4* dr = reinterpret_cast<const uint4*>(
            dout + st.base(bh) + (int64_t)row * st.sl + half * (D / 2));
        const uint4* orow = reinterpret_cast<const uint4*>(
            o + ((int64_t)bh * L + row) * D + half * (D / 2));
#pragma unroll
        for (int u = 0; u < D / 16; ++u) {
          const uint4 a = dr[u], b = orow[u];
          const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
          const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 fa = __bfloat1622float2(pa[e]);
            const float2 fb = __bfloat1622float2(pb[e]);
            s = fmaf(fa.x, fb.x, s);
            s = fmaf(fa.y, fb.y, s);
          }
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (half == 0) delta[(int64_t)bh * LP + row] = row < L ? s : 0.f;
    }
    ring.own_wait(it);
    load_a_frags<D>(qf, sQ + wg * BOX, 2 * BOX, wq, lane);
    ring.own_release(lane);  // Q is in registers: the next item's may load
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
    }
    // tile j + 1's product is issued before tile j's exponentials
    issue(sa, 0);
    for (int j = 0; j < n_kt; j += 2) {
      if (j + 1 < n_kt) {
        issue(sb, j + 1);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs<64>(sa);
      ring.release(t0 + j, lane);
      absorb(sa, j);
      if (j + 1 < n_kt) {
        if (j + 2 < n_kt) {
          issue(sa, j + 2);
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        fence_regs<64>(sb);
        ring.release(t0 + j + 1, lane);
        absorb(sb, j + 1);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float tot = quad_sum(l[r]);
      const int row = q0 + 64 * wg + 16 * wq + g + 8 * r;
      if (t == 0)
        lse[(int64_t)bh * LP + row] = row < L ? m[r] + log2f(tot) : INFINITY;
    }
  }
}

// dK and dV: one item per (b*h, 128 keys, 64 columns of D); warpgroup w
// owns keys 64 w ..; the query tiles of 64 rows stream through the ring.
// Per tile: S^T = K Q^T and dP^T = V dO^T (m64n64; at D 64 with K and V as
// register operands, at D 128 both operands in shared memory), P^T =
// exp2(S^T c - lse), dS^T = P^T (dP^T - delta), then dV += P^T dO and dK +=
// dS^T Q with P^T and dS^T as bf16 register operands.
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dkdv_tma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do, int hl, int H,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int L, int LP, float c,
                   float scale, int n_items) {
  using Cfg = TmaCfg<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sK = smem_base(smem_raw), sV = sK + Cfg::T128;
  const uint32_t sR = sV + Cfg::T128;  // stage s: Q, then dO
  const uint32_t sLD = sR + Cfg::STAGES * 2 * Cfg::T64;  // stage s: lse, delta
  const Ring<Cfg::STAGES> ring{sLD + Cfg::STAGES * 512};
  const float* ld_s = reinterpret_cast<const float*>(
      smem_raw + (sLD - smem_u32(smem_raw)));
  const int n_kt = (L + 127) / 128, n_qt = (L + 63) / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ring.init();

  if (warp >= 8) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 8 && lane == 0) {
      int t = 0;
      for (int i = blockIdx.x, it = 0; i < n_items; i += gridDim.x, ++it) {
        const Item item(i, n_kt, D / 64);
        ring.own_acquire(it);
        mbar_expect_tx(ring.own_full(), 2 * Cfg::T128);
        tma_tile<D, 2>(sK, &tm_k, ring.own_full(), item.row0, item.bh);
        tma_tile<D, 2>(sV, &tm_v, ring.own_full(), item.row0, item.bh);
        for (int j = 0; j < n_qt; ++j, ++t) {
          const int s = t % Cfg::STAGES;
          const uint32_t st_q = sR + s * 2 * Cfg::T64;
          const int64_t r = (int64_t)item.bh * LP + 64 * j;  // < LP
          ring.acquire(t);
          mbar_expect_tx(ring.full(t), 2 * Cfg::T64 + 512);
          tma_tile<D, 1>(st_q, &tm_q, ring.full(t), 64 * j, item.bh);
          tma_tile_do<D, 1>(st_q + Cfg::T64, &tm_do, ring.full(t), 64 * j,
                            item.bh, H, hl);
          bulk_load(sLD + s * 512, lse + r, 256, ring.full(t));
          bulk_load(sLD + s * 512 + 256, delta + r, 256, ring.full(t));
        }
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const uint32_t aK = sK + wg * BOX, aV = sV + wg * BOX;
  // at D 64 this warpgroup's K and V rows are register A operands (a read
  // of shared memory less per product); at D 128 they would not fit
  constexpr bool RS = D == 64;
  uint32_t kf[RS ? D / 4 : 1], vf[RS ? D / 4 : 1];
  float dka[32], dva[32], p[32], dp[32];
  uint32_t pf[16], df[16];
  int t0 = 0;   // the item's first query tile in the ring
  int c0 = 0;   // the item's 64 columns of D
  auto issue_s = [&](int j) {  // S^T and dP^T of tile j
    const uint32_t st_q = sR + ((t0 + j) % Cfg::STAGES) * 2 * Cfg::T64;
    if constexpr (RS) {
      wg_rs_k<D, 64>(p, kf, st_q, BOX);
      wg_rs_k<D, 64>(dp, vf, st_q + Cfg::T64, BOX);
    } else {
      wg_ss<D, 64>(p, aK, 2 * BOX, st_q, BOX);
      wg_ss<D, 64>(dp, aV, 2 * BOX, st_q + Cfg::T64, BOX);
    }
    wgmma_commit();
  };
  auto issue_out = [&](int j) {  // dV and dK of tile j
    const uint32_t st_q =
        sR + ((t0 + j) % Cfg::STAGES) * 2 * Cfg::T64 + (c0 / 64) * BOX;
    wg_rs(dva, pf, st_q + Cfg::T64);
    wg_rs(dka, df, st_q);
    wgmma_commit();
  };
  auto grads = [&](int j) {  // P^T and dS^T of tile j, in place
    const float* lj = ld_s + ((t0 + j) % Cfg::STAGES) * 128;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 ls = *reinterpret_cast<const float2*>(lj + 8 * n + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(lj + 64 + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; e += 2) {  // rows past L: lse +inf, so P 0
        const int i = 4 * n + e;
        p[i] = ex2(fmaf(p[i], c, -ls.x));
        p[i + 1] = ex2(fmaf(p[i + 1], c, -ls.y));
        dp[i] = p[i] * (dp[i] - dl.x);
        dp[i + 1] = p[i + 1] * (dp[i + 1] - dl.y);
      }
    }
  };
  const Turns turns{wg};
  turns.start();
  for (int i = blockIdx.x, it = 0; i < n_items;
       i += gridDim.x, ++it, t0 += n_qt) {
    const Item item(i, n_kt, D / 64);
    const bool last_item = i + (int)gridDim.x >= n_items;
    c0 = item.c0;
#pragma unroll
    for (int e = 0; e < 32; ++e) dka[e] = dva[e] = 0.f;
    ring.own_wait(it);
    if constexpr (RS) {
      load_a_frags<D>(kf, aK, 2 * BOX, wq, lane);
      load_a_frags<D>(vf, aV, 2 * BOX, wq, lane);
      ring.own_release(lane);  // K and V are in registers
    }
    ring.wait_full(t0);
    turns.mine();
    wgmma_fence();
    issue_s(0);
    turns.pass(false);
    wgmma_wait<0>();
    fence_regs<32>(p);
    fence_regs<32>(dp);
    grads(0);
    pack_acc(p, pf);
    pack_acc(dp, df);
    for (int j = 1; j < n_qt; ++j) {
      ring.wait_full(t0 + j);
      fence_regs<16>(pf);
      fence_regs<16>(df);
      fence_regs<32>(dka);
      fence_regs<32>(dva);
      turns.mine();
      wgmma_fence();
      issue_s(j);
      issue_out(j - 1);
      turns.pass(false);
      wgmma_wait<1>();
      fence_regs<32>(p);
      fence_regs<32>(dp);
      grads(j);
      wgmma_wait<0>();
      fence_regs<32>(dka);
      fence_regs<32>(dva);
      fence_regs<16>(pf);
      fence_regs<16>(df);
      ring.release(t0 + j - 1, lane);
      pack_acc(p, pf);
      pack_acc(dp, df);
    }
    if constexpr (!RS) ring.own_release(lane);  // the last S^T and dP^T ran
    fence_regs<32>(dka);
    fence_regs<32>(dva);
    turns.mine();
    wgmma_fence();
    issue_out(n_qt - 1);
    turns.pass(last_item);
    wgmma_wait<0>();
    fence_regs<32>(dka);
    fence_regs<32>(dva);
    ring.release(t0 + n_qt - 1, lane);
    const int64_t base = (int64_t)item.bh * L * D;
    const int row = item.row0 + 64 * wg + 16 * wq + g;
    store_acc<D>(dk + base, dka, row, L, c0, scale, t);
    store_acc<D>(dv + base, dva, row, L, c0, 1.f, t);
  }
}

// dQ: one item per (b*h, 128 queries, 64 columns of D); warpgroup w owns
// queries 64 w .., its Q and dO rows as register operands; the key tiles
// of 64 rows stream through the ring.  Per tile: S = Q K^T and dP = dO V^T
// (m64n64), dS = P (dP - delta) with P 0 past L, then dQ += dS K with dS as
// a bf16 register operand.
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dq_tma(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do, int hl, int H,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int L, int LP, float c,
                 float scale, int n_items) {
  using Cfg = TmaCfg<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = smem_base(smem_raw), sO = sQ + Cfg::T128;
  const uint32_t sR = sO + Cfg::T128;  // stage s: K, then V
  const Ring<Cfg::STAGES> ring{sR + Cfg::STAGES * 2 * Cfg::T64};
  const int n_qt = (L + 127) / 128, n_kt = (L + 63) / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ring.init();

  if (warp >= 8) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 8 && lane == 0) {
      int t = 0;
      for (int i = blockIdx.x, it = 0; i < n_items; i += gridDim.x, ++it) {
        const Item item(i, n_qt, D / 64);
        ring.own_acquire(it);
        mbar_expect_tx(ring.own_full(), 2 * Cfg::T128);
        tma_tile<D, 2>(sQ, &tm_q, ring.own_full(), item.row0, item.bh);
        tma_tile_do<D, 2>(sO, &tm_do, ring.own_full(), item.row0, item.bh,
                          H, hl);
        for (int j = 0; j < n_kt; ++j, ++t) {
          const uint32_t st_k = sR + (t % Cfg::STAGES) * 2 * Cfg::T64;
          ring.acquire(t);
          mbar_expect_tx(ring.full(t), 2 * Cfg::T64);
          tma_tile<D, 1>(st_k, &tm_k, ring.full(t), 64 * j, item.bh);
          tma_tile<D, 1>(st_k + Cfg::T64, &tm_v, ring.full(t), 64 * j,
                         item.bh);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  // this warpgroup's Q and dO rows as register A operands
  uint32_t qf[D / 4], of[D / 4];
  float lr[2], dl[2], dqa[32], p[32], dp[32];
  uint32_t df[16];
  int t0 = 0, c0 = 0;
  auto issue_s = [&](int j) {
    const uint32_t st_k = sR + ((t0 + j) % Cfg::STAGES) * 2 * Cfg::T64;
    wg_rs_k<D, 64>(p, qf, st_k, BOX);
    wg_rs_k<D, 64>(dp, of, st_k + Cfg::T64, BOX);
    wgmma_commit();
  };
  auto issue_out = [&](int j) {
    wg_rs(dqa, df,
          sR + ((t0 + j) % Cfg::STAGES) * 2 * Cfg::T64 + (c0 / 64) * BOX);
    wgmma_commit();
  };
  auto grads = [&](int j) {  // dS of tile j in dp; keys past L: P 0
    const int n_valid = L - 64 * j;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {  // i, i + 1: one row
      const int r = (i >> 1) & 1;
      float2 pe = make_float2(ex2(fmaf(p[i], c, -lr[r])),
                              ex2(fmaf(p[i + 1], c, -lr[r])));
      if (n_valid < 64) {
        if (acc_col(i, t) >= n_valid) pe.x = 0.f;
        if (acc_col(i + 1, t) >= n_valid) pe.y = 0.f;
      }
      dp[i] = pe.x * (dp[i] - dl[r]);
      dp[i + 1] = pe.y * (dp[i + 1] - dl[r]);
    }
  };
  const Turns turns{wg};
  turns.start();
  for (int i = blockIdx.x, it = 0; i < n_items;
       i += gridDim.x, ++it, t0 += n_kt) {
    const Item item(i, n_qt, D / 64);
    const bool last_item = i + (int)gridDim.x >= n_items;
    const int row = item.row0 + 64 * wg + 16 * wq + g;
    c0 = item.c0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // rows < LP; past L: +inf and 0
      lr[r] = lse[(int64_t)item.bh * LP + row + 8 * r];
      dl[r] = delta[(int64_t)item.bh * LP + row + 8 * r];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) dqa[e] = 0.f;
    ring.own_wait(it);
    load_a_frags<D>(qf, sQ + wg * BOX, 2 * BOX, wq, lane);
    load_a_frags<D>(of, sO + wg * BOX, 2 * BOX, wq, lane);
    ring.own_release(lane);  // Q and dO are in registers
    ring.wait_full(t0);
    turns.mine();
    wgmma_fence();
    issue_s(0);
    turns.pass(false);
    wgmma_wait<0>();
    fence_regs<32>(p);
    fence_regs<32>(dp);
    grads(0);
    pack_acc(dp, df);
    for (int j = 1; j < n_kt; ++j) {
      ring.wait_full(t0 + j);
      fence_regs<16>(df);
      fence_regs<32>(dqa);
      turns.mine();
      wgmma_fence();
      issue_s(j);
      issue_out(j - 1);
      turns.pass(false);
      wgmma_wait<1>();
      fence_regs<32>(p);
      fence_regs<32>(dp);
      grads(j);
      wgmma_wait<0>();
      fence_regs<32>(dqa);
      fence_regs<16>(df);
      ring.release(t0 + j - 1, lane);
      pack_acc(dp, df);
    }
    fence_regs<32>(dqa);
    turns.mine();
    wgmma_fence();
    issue_out(n_kt - 1);
    turns.pass(last_item);
    wgmma_wait<0>();
    fence_regs<32>(dqa);
    ring.release(t0 + n_kt - 1, lane);
    store_acc<D>(dq + (int64_t)item.bh * L * D, dqa, row, L, c0, scale, t);
  }
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

int launch_f32w(const float* q, const float* k, const float* v,
                const float* o, const float* dout, const Strides st,
                float* dq, float* dk, float* dv, float* lse, float* delta,
                int BH, int L, int LP, int D, float c, float scale,
                cudaStream_t s) {
  const int vec = D % 4 == 0 &&
                  ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  const int vec_do = D % 4 == 0 && (uintptr_t)dout % 16 == 0 &&
                     st.sl % 4 == 0 && st.sh % 4 == 0 && st.sb % 4 == 0;
  const int pre_bytes = F_ROWS_BYTES + 2 * F_WALK_BYTES;
  const int dkdv_bytes = 4 * F_ROWS_BYTES + 4 * F_WALK_BYTES + 4 * FW * 4;
  const int dq_bytes = 3 * F_ROWS_BYTES + 4 * F_WALK_BYTES;
  const int n_t = (L + FR - 1) / FR;
  cudaError_t e;
  if ((e = smem_attr(flash_bwd_pre_f32w, pre_bytes)) != cudaSuccess ||
      (e = smem_attr(flash_bwd_dkdv_f32w, dkdv_bytes)) != cudaSuccess ||
      (e = smem_attr(flash_bwd_dq_f32w, dq_bytes)) != cudaSuccess)
    return e;
  flash_bwd_pre_f32w<<<dim3(LP / FR, BH), FTHREADS, pre_bytes, s>>>(
      q, k, o, dout, st, lse, delta, L, LP, D, c, vec);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  flash_bwd_dkdv_f32w<<<dim3(n_t, BH), FTHREADS, dkdv_bytes, s>>>(
      q, k, v, dout, st, lse, delta, dk, dv, L, LP, D, c, scale, vec, vec_do);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  flash_bwd_dq_f32w<<<dim3(n_t, BH), FTHREADS, dq_bytes, s>>>(
      q, k, v, dout, st, lse, delta, dq, L, LP, D, c, scale, vec, vec_do);
  return cudaGetLastError();
}

template <int D>
int launch_tma(const __nv_bfloat16* q, const __nv_bfloat16* k,
               const __nv_bfloat16* v, const __nv_bfloat16* o,
               const __nv_bfloat16* dout, const Strides st, int B,
               __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
               float* lse, float* delta, int L, int LP, float c,
               float scale, cudaStream_t s) {
  using Cfg = TmaCfg<D>;
  const int BH = B * st.H;
  CUtensorMap tq, tk, tv, tdo;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)L * D * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  // dout's dims in the order of increasing strides: (D, L, H, B) when it is
  // contiguous, (D, H, L, B) as the U-Net hands it back
  const int hl = st.sh < st.sl;
  const cuuint64_t H = st.H, L64 = L;
  const cuuint64_t do_dims[4] = {(cuuint64_t)D, hl ? H : L64, hl ? L64 : H,
                                 (cuuint64_t)B};
  const cuuint64_t do_strides[3] = {
      (cuuint64_t)(hl ? st.sh : st.sl) * 2,
      (cuuint64_t)(hl ? st.sl : st.sh) * 2, (cuuint64_t)st.sb * 2};
  const cuuint32_t do_box[4] = {64, hl ? 1u : 64u, hl ? 64u : 1u, 1};
  if (!encode_bf16(&tq, q, 3, dims, strides, box) ||
      !encode_bf16(&tk, k, 3, dims, strides, box) ||
      !encode_bf16(&tv, v, 3, dims, strides, box) ||
      !encode_bf16(&tdo, dout, 4, do_dims, do_strides, do_box))
    return ERR_TENSOR_MAP;
  // persistent grids of one CTA an SM (the shared memory allows no more)
  const int n_pre = LP / 128 * BH, n_items = n_pre * (D / 64);
  int dev = 0, n_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = smem_attr(flash_bwd_pre_tma<D>, Cfg::PRE)) != cudaSuccess ||
      (e = smem_attr(flash_bwd_dkdv_tma<D>, Cfg::DKDV)) != cudaSuccess ||
      (e = smem_attr(flash_bwd_dq_tma<D>, Cfg::DQ)) != cudaSuccess)
    return e;
  flash_bwd_pre_tma<D><<<min(n_pre, n_sm), WG_THREADS, Cfg::PRE, s>>>(
      tq, tk, o, dout, st, lse, delta, L, LP, c, n_pre);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  flash_bwd_dkdv_tma<D><<<min(n_items, n_sm), WG_THREADS, Cfg::DKDV, s>>>(
      tq, tk, tv, tdo, hl, st.H, lse, delta, dk, dv, L, LP, c, scale,
      n_items);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  flash_bwd_dq_tma<D><<<min(n_items, n_sm), WG_THREADS, Cfg::DQ, s>>>(
      tq, tk, tv, tdo, hl, st.H, lse, delta, dq, L, LP, c, scale, n_items);
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
// and delta (B*H, LP) f32, LP = L rounded up to 128.  All on the current
// device.  Launches on `stream`, does not synchronise, returns the first
// launch error (0 on success).
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
  const int LP = (L + 127) / 128 * 128;
  const float scale = 1.f / sqrtf((float)D);
  const float c = 1.4426950408889634f * scale;
  if (route == ROUTE_FMA) {
    const auto* qf = static_cast<const float*>(q);
    const auto* kf = static_cast<const float*>(k);
    const auto* vf = static_cast<const float*>(v);
    const auto* of = static_cast<const float*>(o);
    const auto* df = static_cast<const float*>(dout);
    auto* dqf = static_cast<float*>(dq);
    auto* dkf = static_cast<float*>(dk);
    auto* dvf = static_cast<float*>(dv);
    if (D <= 64)
      return launch_f32w(qf, kf, vf, of, df, st, dqf, dkf, dvf, lse, delta,
                         BH, L, LP, D, c, scale, s);
    return launch_f32(qf, kf, vf, of, df, st, dqf, dkf, dvf, lse, delta, BH,
                      L, D, c, scale, s);
  }
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
    if (!vec || !vec_do || (uintptr_t)o % 16 != 0)
      return cudaErrorMisalignedAddress;
    if (D == 64)
      return launch_tma<64>(qb, kb, vb, ob, db, st, B, dqb, dkb, dvb, lse,
                            delta, L, LP, c, scale, s);
    if (D == 128)
      return launch_tma<128>(qb, kb, vb, ob, db, st, B, dqb, dkb, dvb, lse,
                             delta, L, LP, c, scale, s);
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
