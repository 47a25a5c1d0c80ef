// Flash attention for Hopper (sm_90a): non-causal softmax(Q K^T / sqrt(D)) V
// on (B*H, L, D) tensors in f32 or bf16, output in the input dtype.
//
// Replaces the Pallas TPU kernel
// diffusion_models_for_gravitational_waveform_reconstruction_tpu/ops/pallas/attention.py:70
// (flash_attention; body _flash_kernel, :36-66).  Same function and the same
// online-softmax recurrence, with f32 statistics and accumulators:
//     m_new = max(m, rowmax(S));  alpha = exp(m - m_new)
//     l     = l * alpha + rowsum(exp(S - m_new))
//     acc   = acc * alpha + exp(S - m_new) @ V
// and the output acc / max(l, 1e-30) in q's dtype.  Unlike the TPU kernel it
// takes any L >= 1: keys past L score -inf and query rows past L are not
// stored, so the ragged edge needs no rejection and no path around the kernel.
// In bf16, P is rounded to bf16 for the P V product (as the plain version
// rounds softmax(S) to v's dtype); the TPU kernel keeps P in f32.  l sums the
// unrounded f32 P.
//
// What bounds it on the H100.  At the 16 kHz attention U-Net's bottleneck,
// (B, H, L, D) = (32, 4, 4096, 64) in bf16, the two products do
// 4 * B * H * L^2 * D = 549.8 GFLOP against 268 MB of q, k, v and o, about
// 2000 FLOP per byte: operations-bound, with a bound of 0.556 ms at the
// 989 TFLOP/s dense bf16 tensor-core rate.  Nothing of size L x L is ever
// written to device memory.
//
// What the design does about it.  One CTA per (b*h, 64-row Q tile), 4 warps,
// each warp owning 16 query rows.  The CTA streams 64-row K and V tiles
// through shared memory (D zero-padded to the template width DP).
//   bf16: S = Q K^T and O += P V on mma.sync m16n8k16 with f32 accumulation;
//         Q's fragments stay in registers; V's B fragments come from
//         ldmatrix.trans; row max and row sum are reduced over the quad of
//         lanes that share a row.
//   f32:  the same tiling on the FMA units (no TF32), 4 rows x 8 keys per
//         thread, P through shared memory, so f32 agrees with the CPU.
// What this first design leaves slow: mma.sync rather than wgmma, no
// cp.async / TMA double buffering (loads and products do not overlap), one
// Q tile per CTA (each Q tile of a head re-reads its K and V), and 138
// registers a thread at DP = 64, so at most 3 CTAs share an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // query rows per CTA, 16 per warp
constexpr int BK = 64;        // keys per streamed K / V tile
constexpr int THREADS = 128;  // four warps
constexpr int MAX_D = 256;
constexpr int TS = BM + 1;    // row stride of the f32 transposed tiles and P

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices, transposed on the way into registers: lanes 8i..8i+7
// give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 64 rows from row0 of a (L, D) bf16 matrix into dst[64][DP + 8], zero past
// L and past D.  vec: D % 8 == 0 and src 16-byte aligned, so rows load as
// 16-byte vectors.
template <int DP>
__device__ void load_tile_bf16(__nv_bfloat16* dst,
                               const __nv_bfloat16* __restrict__ src,
                               int row0, int L, int D, int vec) {
  constexpr int S = DP + 8;
  if (vec) {
    constexpr int CH = DP / 8;
    for (int idx = threadIdx.x; idx < 64 * CH; idx += THREADS) {
      const int r = idx / CH, c = (idx % CH) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < L && c < D)
        val = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * D + c);
      *reinterpret_cast<uint4*>(dst + r * S + c) = val;
    }
  } else {
    for (int idx = threadIdx.x; idx < 64 * DP; idx += THREADS) {
      const int r = idx / DP, c = idx % DP;
      __nv_bfloat16 val = __float2bfloat16(0.f);
      if (row0 + r < L && c < D) val = src[(int64_t)(row0 + r) * D + c];
      dst[r * S + c] = val;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, int L, int D, float scale_log2,
               int vec) {
  constexpr int S = DP + 8;     // smem row stride: conflict-free fragments
  constexpr int KD = DP / 16;   // k-steps of Q K^T
  constexpr int NK = BK / 8;    // 8-key column tiles of S
  constexpr int ND = DP / 8;    // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + BM * S;
  __nv_bfloat16* vs = ks + BK * S;

  const int q0 = blockIdx.x * BM;
  const int64_t base = (int64_t)blockIdx.y * L * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  load_tile_bf16<DP>(qs, q + base, q0, L, D, vec);
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const __nv_bfloat16* p = qs + r0 * S + kd * 16 + 2 * t;
    qf[kd][0] = ld32(p);
    qf[kd][1] = ld32(p + 8 * S);
    qf[kd][2] = ld32(p + 8);
    qf[kd][3] = ld32(p + 8 * S + 8);
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K / V tile
    load_tile_bf16<DP>(ks, k + base, k0, L, D, vec);
    load_tile_bf16<DP>(vs, v + base, k0, L, D, vec);
    __syncthreads();

    float s[NK][4];
#pragma unroll
    for (int nk = 0; nk < NK; ++nk)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nk][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int nk = 0; nk < NK; ++nk) {
        const __nv_bfloat16* kr = ks + (nk * 8 + g) * S + kd * 16 + 2 * t;
        mma_bf16(s[nk], qf[kd], ld32(kr), ld32(kr + 8));
      }

    // s[nk][e]: row r0 + 8 * (e >> 1), key k0 + nk * 8 + 2 * t + (e & 1);
    // scores in log2 units, keys past L at -inf
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nk = 0; nk < NK; ++nk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nk * 8 + 2 * t + (e & 1);
        const float x = key < L ? s[nk][e] * scale_log2 : -INFINITY;
        s[nk][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // every tile holds key k0 < L, so the new max is finite
      const float mn = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = exp2f(m[i] - mn);
      m[i] = mn;
      l[i] *= alpha[i];  // per-thread partial row sum, reduced at the end
    }
#pragma unroll
    for (int nk = 0; nk < NK; ++nk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nk][e] - m[e >> 1]);
        s[nk][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }

    // O += P V: P's C fragments are the A fragments of the next product
    const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int nd2 = 0; nd2 < DP / 16; ++nd2) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, vs + (kc * 16 + (mi & 1) * 8 + rr) * S + nd2 * 16 + (mi >> 1) * 8);
        mma_bf16(acc[2 * nd2], pa, b[0], b[1]);
        mma_bf16(acc[2 * nd2 + 1], pa, b[2], b[3]);
      }
    }
  }

  float den[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) den[i] = fmaxf(quad_sum(l[i]), 1e-30f);
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + r0 + 8 * (e >> 1), col = nd * 8 + 2 * t + (e & 1);
      if (row < L && col < D)
        o[base + (int64_t)row * D + col] =
            __float2bfloat16(acc[nd][e] / den[e >> 1]);
    }
}

// 64 rows from row0 of a (L, D) f32 matrix into dst[DP][TS], transposed,
// zero past L and past D.
template <int DP>
__device__ void load_tile_t_f32(float* dst, const float* __restrict__ src,
                                int row0, int L, int D) {
  for (int idx = threadIdx.x; idx < 64 * DP; idx += THREADS) {
    const int r = idx / DP, c = idx % DP;
    dst[c * TS + r] =
        (row0 + r < L && c < D) ? src[(int64_t)(row0 + r) * D + c] : 0.f;
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int L, int D,
              float scale_log2) {
  constexpr int ND = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qt = reinterpret_cast<float*>(smem_raw);  // [DP][TS] Q^T
  float* kt = qt + DP * TS;                        // [DP][TS] K^T
  float* vs = kt + DP * TS;                        // [BK][DP] V
  float* ps = vs + BK * DP;                        // [BM][TS] P

  const int q0 = blockIdx.x * BM;
  const int64_t base = (int64_t)blockIdx.y * L * D;
  // thread owns rows ty * 4 + i (i < 4), keys tx + 8 j (j < 8) of S and
  // columns tx + 8 c (c < ND) of O; the 8 lanes of one ty share its rows
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;

  load_tile_t_f32<DP>(qt, q + base, q0, L, D);

  float m[4], l[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < ND; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();
    load_tile_t_f32<DP>(kt, k + base, k0, L, D);
    for (int idx = threadIdx.x; idx < BK * DP; idx += THREADS) {
      const int r = idx / DP, c = idx % DP;
      vs[idx] = (k0 + r < L && c < D) ? v[base + (int64_t)(k0 + r) * D + c]
                                      : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qt[d * TS + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = kt[d * TS + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x = k0 + tx + 8 * j < L ? s[i][j] * scale_log2 : -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - mn);
      m[i] = mn;
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = exp2f(s[i][j] - mn);
        l[i] += p;
        ps[(ty * 4 + i) * TS + tx + 8 * j] = p;
      }
#pragma unroll
      for (int c = 0; c < ND; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // a row's P is written and read by the 8 lanes of one warp

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * TS + kk];
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        const float vv = vs[kk * DP + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    const float den = fmaxf(li, 1e-30f);
    const int row = q0 + ty * 4 + i;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const int col = tx + 8 * c;
      if (row < L && col < D) o[base + (int64_t)row * D + col] = acc[i][c] / den;
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int L, int D, int is_bf16, cudaStream_t st) {
  const dim3 grid((L + BM - 1) / BM, BH);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  cudaError_t e;
  if (is_bf16) {
    const int smem = (BM + 2 * BK) * (DP + 8) * (int)sizeof(__nv_bfloat16);
    e = cudaFuncSetAttribute(flash_fwd_bf16<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const int vec = D % 8 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
    flash_fwd_bf16<DP><<<grid, THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        L, D, scale_log2, vec);
  } else {
    const int smem = (2 * DP * TS + BK * DP + BM * TS) * (int)sizeof(float);
    e = cudaFuncSetAttribute(flash_fwd_f32<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    flash_fwd_f32<DP><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), L, D,
        scale_log2);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v, o (BH, L, D), contiguous on the current device, all f32
// (is_bf16 = 0) or all bf16.  Launches on `stream`, does not synchronise,
// returns the launch error (0 on success).
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* o, int BH, int L, int D, int is_bf16,
                            void* stream) {
  if (BH < 1 || BH > 65535 || L < 1 || D < 1 || D > MAX_D)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch<32>(q, k, v, o, BH, L, D, is_bf16, st);
  if (D <= 64) return launch<64>(q, k, v, o, BH, L, D, is_bf16, st);
  if (D <= 128) return launch<128>(q, k, v, o, BH, L, D, is_bf16, st);
  return launch<256>(q, k, v, o, BH, L, D, is_bf16, st);
}

}  // extern "C"
