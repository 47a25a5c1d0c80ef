// K1's device code: the fused ConvBlock's passes, shared by the forward
// (conv_gn_silu.cu, whose head comment states the design and what bounds
// each pass) and the backward (conv_gn_silu_backward.cu), which recomputes y
// and the group statistics with the same passes and runs the conv pass once
// more, with Cin and Cout swapped, for dx (the DX instantiations: no bias,
// the output in the input's type, no statistics).  Each source compiles
// into its own library, so everything here has internal linkage.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 64;          // rows per partial-statistics tile
constexpr int BN = 64;          // output channels per mma.sync / FMA CTA
constexpr int KC = 32;          // input channels staged per chunk
constexpr int HALO = BM + 2;    // staged x rows: one halo row on each side
constexpr int THREADS = 128;    // four warps, 2 x 2 over the 64 x 64 tile
constexpr int YS = BN + 1;      // row stride of the f32 output tile in smem
constexpr int STATS_THREADS = 256;
constexpr int APPLY_THREADS = 256;
constexpr int APPLY_ELEMS = 16384;  // output elements per apply CTA

constexpr int ROUTE_FMA = 0, ROUTE_MMA_SYNC = 1, ROUTE_WGMMA = 2;

// bf16 staging: a row stride of KC + 8 elements (80 bytes) spreads the 8 rows
// x 4 words of a fragment load over 32 distinct banks.
constexpr int XB = KC + 8;
struct SmemBf16 {
  __nv_bfloat16 xs[HALO][XB];      // x rows l0-1 .. l0+BM, channels c0..c0+KC
  __nv_bfloat16 ws[3][BN][XB];     // W[tap][c0+k][n0+n] stored as [tap][n][k]
};
struct SmemF32 {
  float xs[HALO][KC + 1];
  float ws[3][KC][BN];
};
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int SMEM_BF16 = cmax(int(sizeof(SmemBf16)), BM * YS * 4);
constexpr int SMEM_F32 = cmax(int(sizeof(SmemF32)), BM * YS * 4);

// Write the CTA's f32 tile (already holding conv + bias) to y and the exact
// per-channel (mean, M2) of its valid rows to the partial-statistics arrays.
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The DX epilogue of the mma.sync and FMA conv passes: the CTA's f32 tile to
// `out` in its type, valid rows and channels only, no statistics.
template <typename T>
__device__ void store_tile(const float* ys, T* __restrict__ out, int b,
                           int l0, int n0, int L, int Cout) {
  const int rows = min(BM, L - l0);
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    const int m = idx / BN, n = idx % BN;
    if (m < rows && n0 + n < Cout)
      put(out + ((int64_t)b * L + l0 + m) * Cout + n0 + n, ys[m * YS + n]);
  }
}

__device__ void store_tile_and_stats(const float* ys, float* __restrict__ y,
                                     float* __restrict__ part_mean,
                                     float* __restrict__ part_m2, int b,
                                     int tile, int l0, int n0, int L,
                                     int Cout, int n_tiles) {
  const int rows = min(BM, L - l0);
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    const int m = idx / BN, n = idx % BN;
    if (m < rows && n0 + n < Cout)
      y[((int64_t)b * L + l0 + m) * Cout + n0 + n] = ys[m * YS + n];
  }
  const int n = threadIdx.x;
  if (n < BN && n0 + n < Cout) {
    float s = 0.f;
    for (int m = 0; m < rows; ++m) s += ys[m * YS + n];
    const float mean = s / rows;
    float m2 = 0.f;
    for (int m = 0; m < rows; ++m) {
      const float d = ys[m * YS + n] - mean;
      m2 += d * d;
    }
    const int64_t p = ((int64_t)b * n_tiles + tile) * Cout + n0 + n;
    part_mean[p] = mean;
    part_m2[p] = m2;
  }
}

template <bool DX>
__global__ void __launch_bounds__(THREADS)
conv3_bias_stats_bf16(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ W,
                      const float* __restrict__ bias, float* __restrict__ y,
                      float* __restrict__ part_mean,
                      float* __restrict__ part_m2,
                      __nv_bfloat16* __restrict__ dx, int L, int Cin,
                      int Cout) {
  __shared__ __align__(16) unsigned char smem[SMEM_BF16];
  SmemBf16& s = *reinterpret_cast<SmemBf16*>(smem);
  const int tile = blockIdx.x, l0 = tile * BM, n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* xb = x + (int64_t)b * L * Cin;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += KC) {
    __syncthreads();
    for (int idx = tid; idx < HALO * KC; idx += THREADS) {
      const int r = idx / KC, c = idx % KC;
      const int l = l0 - 1 + r, ch = c0 + c;
      __nv_bfloat16 v = __float2bfloat16(0.f);
      if (l >= 0 && l < L && ch < Cin) v = xb[(int64_t)l * Cin + ch];
      s.xs[r][c] = v;
    }
    for (int idx = tid; idx < 3 * KC * BN; idx += THREADS) {
      const int n = idx % BN, k = (idx / BN) % KC, tap = idx / (BN * KC);
      const int ch = c0 + k, co = n0 + n;
      float v = 0.f;
      if (ch < Cin && co < Cout) v = W[((int64_t)tap * Cin + ch) * Cout + co];
      s.ws[tap][n][k] = __float2bfloat16(v);
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 3; ++tap) {
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        uint32_t a[2][4], bf[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          // output row m reads staged row m + tap (row 0 is l0 - 1)
          const int r = wm + mi * 16 + g + tap;
          a[mi][0] = ld32(&s.xs[r][kk + 2 * t]);
          a[mi][1] = ld32(&s.xs[r + 8][kk + 2 * t]);
          a[mi][2] = ld32(&s.xs[r][kk + 8 + 2 * t]);
          a[mi][3] = ld32(&s.xs[r + 8][kk + 8 + 2 * t]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = wn + ni * 8 + g;
          bf[ni][0] = ld32(&s.ws[tap][n][kk + 2 * t]);
          bf[ni][1] = ld32(&s.ws[tap][n][kk + 8 + 2 * t]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], bf[ni]);
      }
    }
  }

  __syncthreads();  // the staging buffers become the f32 output tile
  float* ys = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int m = wm + mi * 16 + g, n = wn + ni * 8 + 2 * t;
      const float b0 = (!DX && n0 + n < Cout) ? bias[n0 + n] : 0.f;
      const float b1 = (!DX && n0 + n + 1 < Cout) ? bias[n0 + n + 1] : 0.f;
      ys[m * YS + n] = acc[mi][ni][0] + b0;
      ys[m * YS + n + 1] = acc[mi][ni][1] + b1;
      ys[(m + 8) * YS + n] = acc[mi][ni][2] + b0;
      ys[(m + 8) * YS + n + 1] = acc[mi][ni][3] + b1;
    }
  __syncthreads();
  if constexpr (DX)
    store_tile(ys, dx, b, l0, n0, L, Cout);
  else
    store_tile_and_stats(ys, y, part_mean, part_m2, b, tile, l0, n0, L, Cout,
                         gridDim.x);
}

// DX: y is dx (f32), bias is not read
template <bool DX>
__global__ void __launch_bounds__(THREADS)
conv3_bias_stats_f32(const float* __restrict__ x, const float* __restrict__ W,
                     const float* __restrict__ bias, float* __restrict__ y,
                     float* __restrict__ part_mean,
                     float* __restrict__ part_m2, int L, int Cin, int Cout) {
  __shared__ __align__(16) unsigned char smem[SMEM_F32];
  SmemF32& s = *reinterpret_cast<SmemF32*>(smem);
  const int tile = blockIdx.x, l0 = tile * BM, n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;  // 16 x 8
  const float* xb = x + (int64_t)b * L * Cin;

  // thread owns rows ty*8 + i (i < 8) and channels tx + 16*j (j < 4)
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += KC) {
    __syncthreads();
    for (int idx = tid; idx < HALO * KC; idx += THREADS) {
      const int r = idx / KC, c = idx % KC;
      const int l = l0 - 1 + r, ch = c0 + c;
      s.xs[r][c] = (l >= 0 && l < L && ch < Cin) ? xb[(int64_t)l * Cin + ch]
                                                 : 0.f;
    }
    for (int idx = tid; idx < 3 * KC * BN; idx += THREADS) {
      const int n = idx % BN, k = (idx / BN) % KC, tap = idx / (BN * KC);
      const int ch = c0 + k, co = n0 + n;
      s.ws[tap][k][n] = (ch < Cin && co < Cout)
                            ? W[((int64_t)tap * Cin + ch) * Cout + co]
                            : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 3; ++tap) {
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        float a[8], w[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = s.xs[ty * 8 + i + tap][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = s.ws[tap][k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
    }
  }

  __syncthreads();
  float* ys = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = tx + 16 * j;
    const float bj = (!DX && n0 + n < Cout) ? bias[n0 + n] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) ys[(ty * 8 + i) * YS + n] = acc[i][j] + bj;
  }
  __syncthreads();
  if constexpr (DX)
    store_tile(ys, y, b, l0, n0, L, Cout);
  else
    store_tile_and_stats(ys, y, part_mean, part_m2, b, tile, l0, n0, L, Cout,
                         gridDim.x);
}

// ---------------------------------------------------------------------------
// The wgmma route (bf16, Cin % 8 == 0).

constexpr int WM = 128;               // output rows per CTA
constexpr int KCH = 64;               // channels per K chunk: one 128-byte row
constexpr int WG_THREADS = 288;       // warps 0-7 consume, warp 8 loads
constexpr int A_BYTES = WM * KCH * 2;  // one stage of x: 128 rows x 128 bytes
constexpr int PACK_TILE = 32;

template <int TN>
struct WgCfg {
  static constexpr int STAGES = TN == 128 ? 3 : 4;  // ~100 KB: 2 CTAs per SM
  static constexpr int B_BYTES = TN * KCH * 2;
  static constexpr int PIPE = STAGES * (A_BYTES + B_BYTES);
  static constexpr int BARS = 2 * STAGES * 8;
  static constexpr int RED = 2 * 8 * TN * 4;  // (sum, M2) x 8 warps x TN
  static constexpr int SMEM = 1024 + PIPE + BARS + RED;  // 1024: alignment
};

__device__ __forceinline__ float quad_column_sum(float v) {
  // lanes 4g + q, g = 0..7, hold rows of the same column q: sum over g
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

__device__ __forceinline__ void store_y2(float* row, int c, int Cout,
                                         bool pairs, float v0, float v1) {
  if (pairs) {  // Cout even and c even: c < Cout implies c + 1 < Cout
    if (c < Cout) *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
  } else {
    if (c < Cout) row[c] = v0;
    if (c + 1 < Cout) row[c + 1] = v1;
  }
}

__device__ __forceinline__ void store_y2(__nv_bfloat16* row, int c, int Cout,
                                         bool pairs, float v0, float v1) {
  if (pairs) {
    if (c < Cout)
      *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (c < Cout) row[c] = __float2bfloat16(v0);
    if (c + 1 < Cout) row[c + 1] = __float2bfloat16(v1);
  }
}

// One CTA per (TN-channel Cout tile, 128-row L tile, sample).  Warp 8 issues
// the TMA loads; warpgroup w (warps 4w .. 4w+3) computes rows 64w .. 64w+63.
// Accumulator layout of wgmma m64nTN: thread (warp q4, lane 4g + q) holds,
// for each 8-column block j, rows 16 q4 + g and 16 q4 + g + 8 at columns
// 8j + 2q and 8j + 2q + 1 in d[4j .. 4j+3].  DX: no bias, the accumulator
// to dx in bf16, no statistics.
template <int TN, bool DX>
__global__ void __launch_bounds__(WG_THREADS, 2)
conv3_wgmma_bf16(const __grid_constant__ CUtensorMap tmap_x,
                 const __grid_constant__ CUtensorMap tmap_w,
                 const float* __restrict__ bias, float* __restrict__ y,
                 float* __restrict__ part_mean, float* __restrict__ part_m2,
                 __nv_bfloat16* __restrict__ dx, int L, int Cout,
                 int n_chunks, int n_tiles) {
  using Cfg = WgCfg<TN>;
  constexpr int STAGES = Cfg::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sA = smem_u32(smem);
  const uint32_t sB = sA + STAGES * A_BYTES;
  const uint32_t sBar = sB + STAGES * Cfg::B_BYTES;  // full[s], then empty[s]
  float* red = reinterpret_cast<float*>(smem + Cfg::PIPE + Cfg::BARS);

  const int n0 = blockIdx.x * TN, l0 = blockIdx.y * WM, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_iter = 3 * n_chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sBar + 8 * s, 1);                 // the producer's expect_tx
      mbar_init(sBar + 8 * (STAGES + s), 8);      // one arrive per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (lane == 0) {
      for (int i = 0; i < n_iter; ++i) {
        const int s = i % STAGES, chunk = i / 3, tap = i - 3 * chunk;
        mbar_wait(sBar + 8 * (STAGES + s), ((i / STAGES) & 1) ^ 1);
        const uint32_t full = sBar + 8 * s;
        mbar_expect_tx(full, A_BYTES + Cfg::B_BYTES);
        // x rows l0 - 1 + tap ..; rows -1 and >= L, channels >= Cin: zeros
        tma_load_3d(sA + s * A_BYTES, &tmap_x, full, chunk * KCH,
                    l0 - 1 + tap, b);
        tma_load_2d(sB + s * Cfg::B_BYTES, &tmap_w, full,
                    (tap * n_chunks + chunk) * KCH, n0);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
  const uint64_t dA = smem_desc(sA + wg * (A_BYTES / 2));
  const uint64_t dB = smem_desc(sB);
  for (int i = 0; i < n_iter; ++i) {
    const int s = i % STAGES;
    mbar_wait(sBar + 8 * s, (i / STAGES) & 1);
    wgmma_fence();
    const uint64_t da = dA + (uint64_t)((s * A_BYTES) >> 4);
    const uint64_t db = dB + (uint64_t)((s * Cfg::B_BYTES) >> 4);
#pragma unroll
    for (int k = 0; k < KCH / 16; ++k) wgmma_bf16<TN>(acc, da + 2 * k, db + 2 * k);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (i > 0 && lane == 0) mbar_arrive(sBar + 8 * (STAGES + (i - 1) % STAGES));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");

  // epilogue: bias, y for rows < L, per-channel (mean, M2) of each 64 rows
  const int wq = warp & 3, g = lane >> 2, q = lane & 3;
  const int r_lo = l0 + 64 * wg + 16 * wq + g;  // and r_lo + 8
  const bool v0 = r_lo < L, v1 = r_lo + 8 < L;
  const bool pairs = (Cout & 1) == 0;
  if constexpr (DX) {
    __nv_bfloat16* d_lo = dx + ((int64_t)b * L + r_lo) * Cout;
    __nv_bfloat16* d_hi = d_lo + 8 * (int64_t)Cout;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * q;
      if (v0) store_y2(d_lo, c, Cout, pairs, acc[4 * j], acc[4 * j + 1]);
      if (v1) store_y2(d_hi, c, Cout, pairs, acc[4 * j + 2], acc[4 * j + 3]);
    }
    return;
  }
  float* y_lo = y + ((int64_t)b * L + r_lo) * Cout;
  float* y_hi = y_lo + 8 * (int64_t)Cout;
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    const int c = n0 + 8 * j + 2 * q;
    const float b0 = c < Cout ? bias[c] : 0.f;
    const float b1 = c + 1 < Cout ? bias[c + 1] : 0.f;
    acc[4 * j] += b0;
    acc[4 * j + 1] += b1;
    acc[4 * j + 2] += b0;
    acc[4 * j + 3] += b1;
    if (v0) store_y2(y_lo, c, Cout, pairs, acc[4 * j], acc[4 * j + 1]);
    if (v1) store_y2(y_hi, c, Cout, pairs, acc[4 * j + 2], acc[4 * j + 3]);
  }

  const int rows = min(64, L - (l0 + 64 * wg));  // uniform over the warpgroup
  if (rows <= 0) return;
  float* sums = red + wg * 4 * TN;          // [warp of wg][column]
  float* m2s = red + (8 + wg * 4) * TN;
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    const float s0 = quad_column_sum((v0 ? acc[4 * j] : 0.f) +
                                     (v1 ? acc[4 * j + 2] : 0.f));
    const float s1 = quad_column_sum((v0 ? acc[4 * j + 1] : 0.f) +
                                     (v1 ? acc[4 * j + 3] : 0.f));
    if (g == 0) {
      sums[wq * TN + 8 * j + 2 * q] = s0;
      sums[wq * TN + 8 * j + 2 * q + 1] = s1;
    }
  }
  named_barrier(1 + wg, 128);
  const float fr = (float)rows;
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    const int c = 8 * j + 2 * q;
    const float m0 =
        (((sums[c] + sums[TN + c]) + sums[2 * TN + c]) + sums[3 * TN + c]) / fr;
    const float m1 = (((sums[c + 1] + sums[TN + c + 1]) + sums[2 * TN + c + 1]) +
                      sums[3 * TN + c + 1]) / fr;
    const float d00 = v0 ? acc[4 * j] - m0 : 0.f, d01 = v1 ? acc[4 * j + 2] - m0 : 0.f;
    const float d10 = v0 ? acc[4 * j + 1] - m1 : 0.f, d11 = v1 ? acc[4 * j + 3] - m1 : 0.f;
    const float e0 = quad_column_sum(d00 * d00 + d01 * d01);
    const float e1 = quad_column_sum(d10 * d10 + d11 * d11);
    if (g == 0) {
      m2s[wq * TN + c] = e0;
      m2s[wq * TN + c + 1] = e1;
    }
  }
  named_barrier(1 + wg, 128);
  const int t = threadIdx.x & 127;
  if (t < TN && n0 + t < Cout) {
    const float mean =
        (((sums[t] + sums[TN + t]) + sums[2 * TN + t]) + sums[3 * TN + t]) / fr;
    const float m2 =
        ((m2s[t] + m2s[TN + t]) + m2s[2 * TN + t]) + m2s[3 * TN + t];
    const int64_t p = ((int64_t)b * n_tiles + (l0 / BM) + wg) * Cout + n0 + t;
    part_mean[p] = mean;
    part_m2[p] = m2;
  }
}

// W (3, Cin, Cout) f32 -> Wp [Cout_pad][3][Cin_pad] bf16, zero-padded: the
// wgmma B operand, K-major, so each 64-channel K chunk stays inside one tap.
// One CTA per 32 x 32 (channel in, channel out) tile of one tap, transposed
// through shared memory so that reads and writes are both coalesced.
__global__ void __launch_bounds__(256)
pack_weights_bf16(const float* __restrict__ W, __nv_bfloat16* __restrict__ Wp,
                  int Cin, int Cout, int Cin_pad) {
  __shared__ float tile[PACK_TILE][PACK_TILE + 1];
  const int tap = blockIdx.z, ci0 = blockIdx.y * PACK_TILE;
  const int co0 = blockIdx.x * PACK_TILE;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i = ty; i < PACK_TILE; i += 8) {
    const int ci = ci0 + i, co = co0 + tx;
    tile[i][tx] = (ci < Cin && co < Cout)
                      ? W[((int64_t)tap * Cin + ci) * Cout + co]
                      : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < PACK_TILE; i += 8) {
    const int co = co0 + i, ci = ci0 + tx;
    Wp[((int64_t)co * 3 + tap) * Cin_pad + ci] = __float2bfloat16(tile[tx][i]);
  }
}

// Chan et al.'s pairwise update: fold (nb, mb, Mb) into (na, ma, Ma).
__device__ __forceinline__ void chan_merge(float& na, float& ma, float& Ma,
                                           float nb, float mb, float Mb) {
  const float n = na + nb;
  if (nb == 0.f) return;
  const float d = mb - ma;
  ma += d * (nb / n);
  Ma += Mb + d * d * (na * nb / n);
  na = n;
}

// One CTA per (group, sample): merge the per-(tile, channel) partials of the
// group in a fixed order, then a fixed-shape tree over the threads.
__global__ void __launch_bounds__(STATS_THREADS)
group_stats(const float* __restrict__ part_mean,
            const float* __restrict__ part_m2, float* __restrict__ g_mean,
            float* __restrict__ g_rstd, int L, int Cout, int groups,
            int n_tiles, float eps) {
  const int grp = blockIdx.x, b = blockIdx.y, cg = Cout / groups;
  const int P = n_tiles * cg;
  float n_a = 0.f, m_a = 0.f, M_a = 0.f;
  for (int p = threadIdx.x; p < P; p += STATS_THREADS) {
    const int tile = p / cg, c = grp * cg + p % cg;
    const int64_t q = ((int64_t)b * n_tiles + tile) * Cout + c;
    chan_merge(n_a, m_a, M_a, (float)min(BM, L - tile * BM), part_mean[q],
               part_m2[q]);
  }
  __shared__ float sn[STATS_THREADS], sm[STATS_THREADS], sM[STATS_THREADS];
  sn[threadIdx.x] = n_a;
  sm[threadIdx.x] = m_a;
  sM[threadIdx.x] = M_a;
  __syncthreads();
  for (int off = STATS_THREADS / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) {
      const int o = threadIdx.x + off;
      chan_merge(sn[threadIdx.x], sm[threadIdx.x], sM[threadIdx.x], sn[o],
                 sm[o], sM[o]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float var = fmaxf(sM[0] / sn[0], 0.f);
    g_mean[b * groups + grp] = sm[0];
    g_rstd[b * groups + grp] = 1.f / sqrtf(var + eps);
  }
}

template <int V>
__device__ __forceinline__ void load_y(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_out(float* p, const float* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

template <int V>
__device__ __forceinline__ void store_out(__nv_bfloat16* p, const float* v) {
  if constexpr (V == 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
    *p = __float2bfloat16(v[0]);
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The apply pass's epilogue (conv_gn_silu.cu's head comment): none, K1
// alone; FiLM, out = s (1 + gamma) + beta; or the conditioning bias, then
// FiLM, out = (s + bc + r Wc) (1 + gamma) + beta.  film is (B, 2 Cout) =
// [gamma | beta] and r (B, L, K), both in the output's type; wc (K, Cout)
// and bc (Cout,) f32.
constexpr int EPI_NONE = 0, EPI_FILM = 1, EPI_COND_FILM = 2;
// rows per apply CTA with the conditioning bias, at most: the CTA stages
// wc and its rows of r in shared memory, 4 K (Cout + rows) bytes
constexpr int EPI_ROWS = 1024;
struct Epilogue {
  const void* film;
  const void* r;
  const float* wc;
  const float* bc;
  int K;
};

// One CTA per (run of `rows_per_cta` rows, sample); V channels per thread
// (V = 4 when Cout % 4 == 0).  A thread keeps its channels' coefficients in
// registers and steps over rows, so no index is divided per element.  With
// an epilogue it also keeps its channels' 1 + gamma and beta (and bc); for
// the conditioning bias the CTA first stages wc and the K values of each
// of its rows of r in f32 in shared memory, which the threads of a row read
// as one broadcast.  The pass is bytes-bound and needs its loads in
// flight, so its registers are held to 4 CTAs an SM with an epilogue, and
// without one to the 6 (bf16) or 5 (f32) that it took before it had one.
template <typename T, int V, int EPI>
__global__ void __launch_bounds__(APPLY_THREADS,
                                  EPI != EPI_NONE ? 4 : sizeof(T) == 2 ? 6 : 5)
gn_affine_silu(const float* __restrict__ y, const float* __restrict__ g_mean,
               const float* __restrict__ g_rstd,
               const float* __restrict__ scale,
               const float* __restrict__ shift, T* __restrict__ out, int L,
               int Cout, int groups, int rows_per_cta, Epilogue ep) {
  extern __shared__ float epi_smem[];   // wc (K, Cout), then r's rows
  const int b = blockIdx.y;
  const int r_begin = blockIdx.x * rows_per_cta;
  const int r_end = min(L, r_begin + rows_per_cta);
  const int nq = Cout / V, cg = Cout / groups;
  const int K = EPI == EPI_COND_FILM ? ep.K : 0;
  float* wcs = epi_smem;
  float* rs = epi_smem + K * Cout;
  if constexpr (EPI == EPI_COND_FILM) {
    const T* r0p =
        static_cast<const T*>(ep.r) + ((int64_t)b * L + r_begin) * K;
    for (int i = threadIdx.x; i < K * Cout; i += APPLY_THREADS)
      wcs[i] = ep.wc[i];
    for (int i = threadIdx.x; i < (r_end - r_begin) * K; i += APPLY_THREADS)
      rs[i] = to_f32(r0p[i]);
    __syncthreads();
  }
  int q0, q_step, r0, r_step;
  if (nq >= APPLY_THREADS) {
    q0 = threadIdx.x; q_step = APPLY_THREADS; r0 = 0; r_step = 1;
  } else {
    r_step = APPLY_THREADS / nq;
    if (threadIdx.x >= r_step * nq) return;
    q0 = threadIdx.x % nq; q_step = nq; r0 = threadIdx.x / nq;
  }
  const T* __restrict__ film = static_cast<const T*>(ep.film);
  for (int qi = q0; qi < nq; qi += q_step) {
    const int c = qi * V;
    float mu[V], a[V], sh[V], g1[V], be[V], bc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int gi = b * groups + (c + v) / cg;
      mu[v] = g_mean[gi];
      a[v] = g_rstd[gi] * scale[c + v];
      sh[v] = shift[c + v];
      if constexpr (EPI != EPI_NONE) {
        g1[v] = 1.f + to_f32(film[(int64_t)b * 2 * Cout + c + v]);
        be[v] = to_f32(film[(int64_t)b * 2 * Cout + Cout + c + v]);
      }
      if constexpr (EPI == EPI_COND_FILM) bc[v] = ep.bc[c + v];
    }
    for (int r = r_begin + r0; r < r_end; r += r_step) {
      const int64_t i = ((int64_t)b * L + r) * Cout + c;
      float h[V];
      load_y<V>(y + i, h);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float t = (h[v] - mu[v]) * a[v] + sh[v];
        h[v] = t * (1.f / (1.f + expf(-t)));
      }
      if constexpr (EPI == EPI_COND_FILM) {
        const float* rr = rs + (r - r_begin) * K;
        float p[V];
#pragma unroll
        for (int v = 0; v < V; ++v) p[v] = bc[v];
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
          const float rk = rr[k];
          float w[V];
          load_y<V>(wcs + k * Cout + c, w);
#pragma unroll
          for (int v = 0; v < V; ++v) p[v] = fmaf(rk, w[v], p[v]);
        }
#pragma unroll
        for (int v = 0; v < V; ++v) h[v] += p[v];
      }
      if constexpr (EPI != EPI_NONE) {
#pragma unroll
        for (int v = 0; v < V; ++v) h[v] = fmaf(h[v], g1[v], be[v]);
      }
      store_out<V>(out + i, h);
    }
  }
}

template <typename T>
using ApplyKernel = void (*)(const float*, const float*, const float*,
                             const float*, const float*, T*, int, int, int,
                             int, Epilogue);

template <typename T, int EPI>
cudaError_t launch_apply_v(const float* y, const float* g_mean,
                           const float* g_rstd, const float* scale,
                           const float* shift, T* out, int B, int L, int Cout,
                           int groups, const Epilogue& ep, cudaStream_t st) {
  int rows = cmax(1, APPLY_ELEMS / Cout);
  ApplyKernel<T> kernel = Cout % 4 == 0 ? gn_affine_silu<T, 4, EPI>
                                        : gn_affine_silu<T, 1, EPI>;
  size_t smem = 0;
  if constexpr (EPI == EPI_COND_FILM) {
    rows = rows < EPI_ROWS ? rows : EPI_ROWS;
    smem = sizeof(float) * (size_t)ep.K * (rows + Cout);
  }
  const dim3 grid((L + rows - 1) / rows, B);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, APPLY_THREADS, smem, st>>>(y, g_mean, g_rstd, scale, shift,
                                            out, L, Cout, groups, rows, ep);
  return cudaGetLastError();
}

// The apply pass, with the epilogue that `ep` asks for: none without film,
// FiLM alone without r.
template <typename T>
cudaError_t launch_apply(const float* y, const float* g_mean,
                         const float* g_rstd, const float* scale,
                         const float* shift, T* out, int B, int L, int Cout,
                         int groups, const Epilogue& ep, cudaStream_t st) {
  if (ep.film == nullptr)
    return launch_apply_v<T, EPI_NONE>(y, g_mean, g_rstd, scale, shift, out,
                                       B, L, Cout, groups, ep, st);
  if (ep.r == nullptr)
    return launch_apply_v<T, EPI_FILM>(y, g_mean, g_rstd, scale, shift, out,
                                       B, L, Cout, groups, ep, st);
  return launch_apply_v<T, EPI_COND_FILM>(y, g_mean, g_rstd, scale, shift,
                                          out, B, L, Cout, groups, ep, st);
}

template <int TN, bool DX>
int launch_wgmma(const __nv_bfloat16* x, const __nv_bfloat16* Wp,
                 const float* bias, float* y, float* part_mean,
                 float* part_m2, __nv_bfloat16* dx, int B, int L, int Cin,
                 int Cout, cudaStream_t st) {
  const int n_chunks = (Cin + KCH - 1) / KCH;
  const int cin_pad = n_chunks * KCH;
  const int cout_pad = (Cout + KCH - 1) / KCH * KCH;
  CUtensorMap tmx, tmw;
  const cuuint64_t x_dims[3] = {(cuuint64_t)Cin, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t x_strides[2] = {(cuuint64_t)Cin * 2,
                                   (cuuint64_t)L * Cin * 2};
  const cuuint32_t x_box[3] = {KCH, WM, 1};
  const cuuint64_t w_dims[2] = {(cuuint64_t)3 * cin_pad, (cuuint64_t)cout_pad};
  const cuuint64_t w_strides[1] = {(cuuint64_t)3 * cin_pad * 2};
  const cuuint32_t w_box[2] = {KCH, TN};
  if (!encode_bf16(&tmx, x, 3, x_dims, x_strides, x_box) ||
      !encode_bf16(&tmw, Wp, 2, w_dims, w_strides, w_box))
    return ERR_TENSOR_MAP;
  cudaError_t e = cudaFuncSetAttribute(
      conv3_wgmma_bf16<TN, DX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      WgCfg<TN>::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((Cout + TN - 1) / TN, (L + WM - 1) / WM, B);
  conv3_wgmma_bf16<TN, DX><<<grid, WG_THREADS, WgCfg<TN>::SMEM, st>>>(
      tmx, tmw, bias, y, part_mean, part_m2, dx, L, Cout, n_chunks,
      (L + BM - 1) / BM);
  return cudaGetLastError();
}

// The forward's first two passes, which the backward repeats: y = conv3(x)
// + bias in f32 with the per-(tile, channel) (mean, M2) partials on the
// route given (for route 2 the weights packed into w_packed first), then
// the group statistics.  Returns the first launch error (0 on success).
inline int conv_y_stats(const void* x, const float* W, const float* bias,
                        float* y, float* part_mean, float* part_m2,
                        float* g_mean, float* g_rstd, void* w_packed, int B,
                        int L, int Cin, int Cout, int groups, float eps,
                        int route, cudaStream_t st) {
  const int n_tiles = (L + BM - 1) / BM;
  cudaError_t e;
  if (route == ROUTE_WGMMA) {
    const int cin_pad = (Cin + KCH - 1) / KCH * KCH;
    const int cout_pad = (Cout + KCH - 1) / KCH * KCH;
    auto* Wp = static_cast<__nv_bfloat16*>(w_packed);
    pack_weights_bf16<<<dim3(cout_pad / PACK_TILE, cin_pad / PACK_TILE, 3),
                        256, 0, st>>>(W, Wp, Cin, Cout, cin_pad);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const int rc =
        Cout > 64 ? launch_wgmma<128, false>(xb, Wp, bias, y, part_mean,
                                             part_m2, nullptr, B, L, Cin,
                                             Cout, st)
                  : launch_wgmma<64, false>(xb, Wp, bias, y, part_mean,
                                            part_m2, nullptr, B, L, Cin, Cout,
                                            st);
    if (rc != 0) return rc;
  } else {
    const dim3 grid(n_tiles, (Cout + BN - 1) / BN, B);
    if (route == ROUTE_MMA_SYNC)
      conv3_bias_stats_bf16<false><<<grid, THREADS, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), W, bias, y, part_mean,
          part_m2, nullptr, L, Cin, Cout);
    else
      conv3_bias_stats_f32<false><<<grid, THREADS, 0, st>>>(
          static_cast<const float*>(x), W, bias, y, part_mean, part_m2, L,
          Cin, Cout);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  group_stats<<<dim3(groups, B), STATS_THREADS, 0, st>>>(
      part_mean, part_m2, g_mean, g_rstd, L, Cout, groups, n_tiles, eps);
  return cudaGetLastError();
}

// dx = conv3(dy) with the taps flipped and each transposed: the conv pass
// with the channels swapped (dy has Ci channels, dx Co), no bias and no
// statistics.  w_t (3, Ci, Co) f32 holds the flipped, transposed taps; for
// route 2 (bf16, Ci % 8 == 0, dy 16-byte aligned) they are packed into
// wt_packed (Co_pad, 3, Ci_pad) bf16 first.  dx in dy's type.
inline int conv_dx(const void* dy, const float* w_t, void* wt_packed,
                   void* dx, int B, int L, int Ci, int Co, int route,
                   cudaStream_t st) {
  if (route == ROUTE_WGMMA) {
    const int ci_pad = (Ci + KCH - 1) / KCH * KCH;
    const int co_pad = (Co + KCH - 1) / KCH * KCH;
    auto* Wp = static_cast<__nv_bfloat16*>(wt_packed);
    pack_weights_bf16<<<dim3(co_pad / PACK_TILE, ci_pad / PACK_TILE, 3), 256,
                        0, st>>>(w_t, Wp, Ci, Co, ci_pad);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const auto* dyb = static_cast<const __nv_bfloat16*>(dy);
    auto* dxb = static_cast<__nv_bfloat16*>(dx);
    return Co > 64 ? launch_wgmma<128, true>(dyb, Wp, nullptr, nullptr,
                                             nullptr, nullptr, dxb, B, L, Ci,
                                             Co, st)
                   : launch_wgmma<64, true>(dyb, Wp, nullptr, nullptr,
                                            nullptr, nullptr, dxb, B, L, Ci,
                                            Co, st);
  }
  const dim3 grid((L + BM - 1) / BM, (Co + BN - 1) / BN, B);
  if (route == ROUTE_MMA_SYNC)
    conv3_bias_stats_bf16<true><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dy), w_t, nullptr, nullptr,
        nullptr, nullptr, static_cast<__nv_bfloat16*>(dx), L, Ci, Co);
  else
    conv3_bias_stats_f32<true><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(dy), w_t, nullptr,
        static_cast<float*>(dx), nullptr, nullptr, L, Ci, Co);
  return cudaGetLastError();
}

}  // namespace
