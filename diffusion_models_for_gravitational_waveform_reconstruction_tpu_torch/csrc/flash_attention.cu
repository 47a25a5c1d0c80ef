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
// written to device memory.  At D 64 the softmax's B * H * L^2 = 2.1 G
// exponentials cost about as much on the SFUs (16 per clock per SM) as the
// products on the tensor cores, so the two must overlap.
//
// Three routes, chosen by the caller from the inputs:
//   wgmma (bf16, D 64 or 128, q, k, v 16-byte aligned): the serving route,
//     FlashAttention-3's shape.  A persistent grid of one 384-thread CTA per
//     SM walks work items (a 128-row Q tile of one head).  Warpgroup 2 is
//     the producer: setmaxnreg lowers it to 24 registers and one thread
//     issues every TMA load, Q once per item and K / V tiles of 128 keys
//     into a ring of stages (4 at D 64, 3 at D 128) guarded by full and
//     empty mbarriers; tensor maps over (D, L, B*H), 128B-swizzled, so rows
//     past L come back zero and no tile reads the next head.  Warpgroups 0
//     and 1 (240 registers each) own 64 Q rows each.  S = Q K^T runs on
//     wgmma m64n128k16 with both operands in shared memory; the online
//     softmax runs on S's accumulator fragment (row max and sum over the
//     quad of lanes of a row, ex2.approx); P is repacked in registers as
//     the bf16 A operand of O += P V on wgmma m64nDk16, whose B is V read
//     MN-major through the descriptor's transpose bit (no transposed copy).
//     Within a warpgroup tile j's Q K^T and tile j-1's P V are issued
//     together, so tile j's softmax overlaps P V on the tensor cores.  The
//     epilogue stores O / max(l, 1e-30) from registers, rows < L only.
//   mma_sync (other bf16 inputs): one CTA per (b*h, 64-row Q tile), 4 warps
//     of 16 rows, 64-row K / V tiles through shared memory (D zero-padded to
//     the template width DP), both products on mma.sync m16n8k16, V's
//     fragments from ldmatrix.trans.
//   fma (f32): the same tiling on the FMA units (no TF32), P through shared
//     memory, so f32 agrees with the CPU.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 64;        // query rows per CTA, 16 per warp
constexpr int BK = 64;        // keys per streamed K / V tile
constexpr int THREADS = 128;  // four warps
constexpr int MAX_D = 256;
constexpr int TS = BM + 1;    // row stride of the f32 transposed tiles and P
constexpr int ROUTE_FMA = 0, ROUTE_MMA_SYNC = 1, ROUTE_WGMMA = 2;

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

// ---------------------------------------------------------------------------
// The wgmma route (bf16, D 64 or 128, q, k, v on 16-byte aligned bases).

constexpr int WG_BM = 128;         // query rows per CTA: two warpgroups of 64
constexpr int WG_BN = 128;         // keys per K / V tile
constexpr int WG_THREADS = 384;    // warpgroups 0-1 consume, warpgroup 2 loads
constexpr int BOX_BYTES = WG_BN * 64 * 2;  // one 64-column box of 128 rows
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

template <int D>
struct FaCfg {
  static constexpr int BOXES = D / 64;
  static constexpr int TILE = BOXES * BOX_BYTES;   // 128 rows x D bf16
  static constexpr int STAGES = D == 64 ? 4 : 3;  // 144 / 225 KB: 1 CTA per SM
  static constexpr int BARS = 8 * (2 * STAGES + 2);
  static constexpr int SMEM = 1024 + TILE + STAGES * 2 * TILE + BARS;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one 64 x 128 score tile held as the accumulator of
// wgmma m64n128: this thread's sc[4j + e] is row g + 8 (e >> 1), key
// 8j + 2q + (e & 1) of the tile.  Keys >= n_valid score -inf.  On return
// sc holds P = exp2(S * c - m * c) in f32, m and l are updated (l as this
// thread's partial sum of its columns), and alpha holds the factor by which
// the rows' earlier O must be rescaled.
__device__ __forceinline__ void softmax_tile(float* sc, float* m, float* l,
                                             float* alpha, int n_valid,
                                             float c, int q) {
  if (n_valid < WG_BN) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (8 * (i >> 2) + 2 * q + (i & 1) >= n_valid) sc[i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    mx[r] = fmaxf(mx[r], sc[i]);
  }
  float mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // every tile holds a key < L, so the new max is finite
    const float mn = fmaxf(m[r], quad_max(mx[r]));
    alpha[r] = ex2((m[r] - mn) * c);
    m[r] = mn;
    mc[r] = mn * c;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    const float p = ex2(fmaf(sc[i], c, -mc[r]));
    sc[i] = p;
    sum[r] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

// P (f32, accumulator layout) -> the register A operand of the P V product,
// bf16: k-step kc takes keys 16 kc .. 16 kc + 15, i.e. sc[8 kc .. 8 kc + 7].
__device__ __forceinline__ void pack_p(const float* sc, uint32_t* pf) {
#pragma unroll
  for (int i = 0; i < 32; ++i) pf[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
}

template <int D>
__device__ __forceinline__ void scale_o(float* o, const float* alpha) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// S = Q K^T for one warpgroup's 64 rows: D / 16 k-steps, each box of 64
// columns 4 of them, 32 bytes apart inside the swizzled 128-byte rows.
template <int D>
__device__ __forceinline__ void gemm_qk(float* sc, uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    const uint64_t off =
        (uint64_t)((kd >> 2) * (BOX_BYTES >> 4) + 2 * (kd & 3));
    wgmma_bf16<128>(sc, dq + off, dk + off, kd > 0);
  }
}

// O += P V: 8 k-steps of 16 keys, V MN-major (D contiguous), each step 16
// rows of 128 bytes further on.
template <int D>
__device__ __forceinline__ void gemm_pv(float* o, const uint32_t* pf,
                                        uint64_t dv) {
#pragma unroll
  for (int kc = 0; kc < WG_BN / 16; ++kc)
    wgmma_rs_bf16_tb<D>(o, pf + 4 * kc, dv + (uint64_t)(kc * (2048 >> 4)));
}

// Work item i is Q tile i % n_qt of head i / n_qt; a CTA takes items
// blockIdx.x, blockIdx.x + gridDim.x, ...  Warp 8 issues every TMA load:
// per item Q once (q_full; q_empty when both warpgroups have finished the
// item's last Q K^T), then K and V tile by tile into a ring of STAGES
// stages that runs on across items (full: the bytes arrived; empty: the 8
// consumer warps are done with it).  Warpgroup w (warps 4w .. 4w+3) owns Q
// rows 64w .. 64w+63 of each item.
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wgmma_bf16(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     __nv_bfloat16* __restrict__ o, int L, int n_items,
                     float c) {
  using Cfg = FaCfg<D>;
  constexpr int STAGES = Cfg::STAGES, TILE = Cfg::TILE;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ =
      smem_u32(smem_raw) + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sKV = sQ + TILE;  // stage s: K at sKV + 2 s TILE, V after it
  const uint32_t sBar = sKV + STAGES * 2 * TILE;  // full[s], empty[s], q
  const uint32_t q_full = sBar + 16 * STAGES, q_empty = q_full + 8;
  const int n_tiles = (L + WG_BN - 1) / WG_BN;  // Q tiles and K / V tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sBar + 8 * s, 1);
      mbar_init(sBar + 8 * (STAGES + s), 8);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: one thread issues every load
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 8 && lane == 0) {
      int t = 0;  // K / V tiles loaded so far, over all items
      for (int item = blockIdx.x, it = 0; item < n_items;
           item += gridDim.x, ++it) {
        const int q0 = (item % n_tiles) * WG_BM, bh = item / n_tiles;
        mbar_wait(q_empty, (it & 1) ^ 1);
        mbar_expect_tx(q_full, TILE);
        for (int b = 0; b < Cfg::BOXES; ++b)
          tma_load_3d(sQ + b * BOX_BYTES, &tm_q, q_full, 64 * b, q0, bh);
        for (int j = 0; j < n_tiles; ++j, ++t) {
          const int s = t % STAGES;
          mbar_wait(sBar + 8 * (STAGES + s), ((t / STAGES) & 1) ^ 1);
          const uint32_t full = sBar + 8 * s, sk = sKV + s * 2 * TILE;
          mbar_expect_tx(full, 2 * TILE);
          // rows past L come back as zeros; the head index keeps a tile
          // inside its own head
          for (int b = 0; b < Cfg::BOXES; ++b) {
            tma_load_3d(sk + b * BOX_BYTES, &tm_k, full, 64 * b, j * WG_BN,
                        bh);
            tma_load_3d(sk + TILE + b * BOX_BYTES, &tm_v, full, 64 * b,
                        j * WG_BN, bh);
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, q = lane & 3;
  const uint64_t dq = smem_desc(sQ + wg * (BOX_BYTES / 2));
  const uint64_t dk = smem_desc(sKV);
  const uint64_t dv = smem_desc_mn(sKV + TILE, BOX_BYTES);
  auto stage_off = [&](int t) {  // descriptor offset of tile t's stage
    return (uint64_t)(((t % STAGES) * 2 * TILE) >> 4);
  };
  auto wait_full = [&](int t) {
    mbar_wait(sBar + 8 * (t % STAGES), (t / STAGES) & 1);
  };
  auto release = [&](int t) {
    if (lane == 0) mbar_arrive(sBar + 8 * (STAGES + t % STAGES));
  };
  auto release_q = [&]() {
    if (lane == 0) mbar_arrive(q_empty);
  };

  int t0 = 0;  // the item's first K / V tile, counted over all items
  for (int item = blockIdx.x, it = 0; item < n_items;
       item += gridDim.x, ++it, t0 += n_tiles) {
    const int q0 = (item % n_tiles) * WG_BM, bh = item / n_tiles;
    float oacc[D / 2], sc[64], m[2] = {-INFINITY, -INFINITY},
          l[2] = {0.f, 0.f}, alpha[2];
    uint32_t pf[32];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    mbar_wait(q_full, it & 1);
    // tile j's Q K^T and tile j-1's P V are issued together, so that tile
    // j's softmax runs while P V is on the tensor cores
    wait_full(t0);
    wgmma_fence();
    gemm_qk<D>(sc, dq, dk + stage_off(t0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<64>(sc);
    if (n_tiles == 1) release_q();
    softmax_tile(sc, m, l, alpha, min(WG_BN, L), c, q);
    pack_p(sc, pf);
    for (int j = 1; j < n_tiles; ++j) {
      wait_full(t0 + j);
      fence_regs<64>(sc);
      fence_regs<D / 2>(oacc);
      wgmma_fence();
      gemm_qk<D>(sc, dq, dk + stage_off(t0 + j));
      wgmma_commit();
      gemm_pv<D>(oacc, pf, dv + stage_off(t0 + j - 1));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs<64>(sc);
      if (j == n_tiles - 1) release_q();
      softmax_tile(sc, m, l, alpha, min(WG_BN, L - j * WG_BN), c, q);
      wgmma_wait<0>();
      fence_regs<D / 2>(oacc);
      fence_regs<32>(pf);
      release(t0 + j - 1);
      scale_o<D>(oacc, alpha);
      pack_p(sc, pf);
    }
    fence_regs<D / 2>(oacc);
    wgmma_fence();
    gemm_pv<D>(oacc, pf, dv + stage_off(t0 + n_tiles - 1));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(oacc);
    fence_regs<32>(pf);
    release(t0 + n_tiles - 1);

    // O / max(l, 1e-30) in bf16, rows < L only
    const int64_t base = (int64_t)bh * L * D;
    const int row = q0 + 64 * wg + 16 * wq + g;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float den = fmaxf(quad_sum(l[r]), 1e-30f);
      if (row + 8 * r >= L) continue;
      __nv_bfloat16* out = o + base + (int64_t)(row + 8 * r) * D + 2 * q;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + 8 * j) = pack_bf16(
            oacc[4 * j + 2 * r] / den, oacc[4 * j + 2 * r + 1] / den);
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int BH,
                 int L, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)L * D * 2};
  const cuuint32_t box[3] = {64, WG_BN, 1};
  if (!encode_bf16(&tq, q, 3, dims, strides, box) ||
      !encode_bf16(&tk, k, 3, dims, strides, box) ||
      !encode_bf16(&tv, v, 3, dims, strides, box))
    return ERR_TENSOR_MAP;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FaCfg<D>::SMEM);
  if (e != cudaSuccess) return e;
  // a persistent grid, one CTA per SM: the shared memory allows no more
  const int n_items = (L + WG_BM - 1) / WG_BM * BH;
  int dev = 0, n_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  flash_fwd_wgmma_bf16<D><<<min(n_items, n_sm), WG_THREADS, FaCfg<D>::SMEM,
                            st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), L, n_items,
      1.4426950408889634f / sqrtf((float)D));
  return cudaGetLastError();
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
  return error_string(code);
}

// q, k, v, o (BH, L, D), contiguous on the current device: f32 for route 0
// (FMA), bf16 for route 1 (mma.sync) and route 2 (wgmma: D 64 or 128, q, k
// and v 16-byte aligned).  Launches on `stream`, does not synchronise,
// returns the launch error (0 on success).
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* o, int BH, int L, int D, int route,
                            void* stream) {
  if (BH < 1 || BH > 65535 || L < 1 || D < 1 || D > MAX_D)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_WGMMA) {
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 != 0)
      return cudaErrorMisalignedAddress;
    if (D == 64) return launch_wgmma<64>(q, k, v, o, BH, L, st);
    if (D == 128) return launch_wgmma<128>(q, k, v, o, BH, L, st);
    return cudaErrorInvalidValue;
  }
  const int is_bf16 = route == ROUTE_MMA_SYNC;
  if (!is_bf16 && route != ROUTE_FMA) return cudaErrorInvalidValue;
  if (D <= 32) return launch<32>(q, k, v, o, BH, L, D, is_bf16, st);
  if (D <= 64) return launch<64>(q, k, v, o, BH, L, D, is_bf16, st);
  if (D <= 128) return launch<128>(q, k, v, o, BH, L, D, is_bf16, st);
  return launch<256>(q, k, v, o, BH, L, D, is_bf16, st);
}

}  // extern "C"
