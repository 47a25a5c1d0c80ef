// Backward of the fused ConvBlock for Hopper (sm_90a): the gradients (dx,
// dW, db, dscale, dbias) of conv1d(k=3, SAME) + bias -> GroupNorm -> affine
// -> SiLU on channels-last (B, L, C) activations, given dout.
//
// The backward of K1, the Pallas TPU kernel
// diffusion_models_for_gravitational_waveform_reconstruction_tpu/ops/pallas/fused.py:87.
// The JAX package has no kernel for it: that Pallas ConvBlock is
// forward-only, and its trainer differentiates the plain expression
// fused_conv_gn_silu_reference (fused.py:26-40) with XLA's autodiff.  This
// kernel computes the gradients of the port's plain backward
// (ops/kernels/conv_gn_silu.py::fused_conv_gn_silu_backward) with its cast
// points: the conv's two products take their operands in x's dtype and
// accumulate in f32, the GroupNorm and SiLU algebra is f32, dy goes to x's
// dtype before the products, and db is summed from the f32 dy.  y is
// recomputed in f32 as the forward kernel computes it.
//
// Passes, all on the caller's stream.  No float atomics: every sum is taken
// in a fixed order, so two runs on the same inputs give the same bits.
//   1. recompute: y = conv3(x) + b in f32 and the group statistics with the
//      forward's own conv and group_stats passes on the forward's route
//      (conv_gn_silu.cuh), so x-hat is the forward's;
//   2. k1b_gn_grad<PARTIALS>: per (64-row tile, channel), the tile's sums of
//      dh = dout s(h) (1 + h (1 - s(h))) and of dh x-hat;
//   3. k1b_sum_rows: those partials per (sample, channel), then per channel
//      (dbias, dscale); k1b_group_coef: per (sample, group) the means of
//      dx-hat = dh scale and of dx-hat x-hat;
//   4. k1b_gn_grad<APPLY>: dy = (dx-hat - mean(dx-hat) - x-hat mean(dx-hat
//      x-hat)) rstd in x's dtype, and its per-tile f32 sums, which
//      k1b_sum_rows turns into db;
//   5. dx = conv3(dy) with the taps flipped and each transposed
//      (k1b_flip_taps, then the forward's conv pass with Cin and Cout
//      swapped: wgmma against the packed (Cin_pad, 3, Cout_pad) weights for
//      bf16 with Cout % 8 == 0, mma.sync for other bf16, FMA for f32);
//   6. dW = im2col3(x)^T dy, (3 Cin x B L) (B L x Cout): K = B L is cut
//      into tiles of up to 64 rows of one sample and the tiles into runs,
//      one f32 partial of dW per run, summed in run order by k1b_sum_rows.
//      bf16 with Cin % 8 == 0 and Cout % 8 == 0 (every block but the input
//      block) on wgmma fed by a TMA ring (k1b_dw_tma: both operands
//      MN-major, the three taps as three boxes of x one row apart); other
//      bf16 on mma.sync (k1b_dw_bf16: TMA cannot map the input block's
//      14-byte rows); f32 on the FMA units (k1b_dw_f32, double-buffered
//      through cp.async, the taps sharing one staged x tile).
//
// What bounds it on the H100.  Three conv products of 2 B L 3 Cin Cout FLOPs
// each (the recompute, dx, dW) against the bytes of x, dout, dx and the
// parameter gradients; at the U-Nets' training shapes the bytes of the
// activations set the bound for the narrow blocks, the products for the
// wide ones.  y goes to device memory in f32 and is read twice, dy is
// written once and read twice (keeping y out of device memory is later
// work).  dW streams its operands through TMA into wgmma: both are
// MN-major (channels contiguous), which the descriptors' transpose bits
// take as they are, and the three taps reuse one dy box against three x
// boxes one row apart, so x is read from L2 three times and from device
// memory about once.
#include "conv_gn_silu.cuh"

namespace {

constexpr int GRAD_THREADS = 256;
constexpr int SUM_LANES = 8;      // k1b_sum_rows: lanes a column is cut into
constexpr int DW_STEP = 64;       // rows of one sample per dW tile
constexpr int DW_BM = 64;         // input channels per dW CTA
constexpr int DW_BN = 64;         // output channels per dW CTA
constexpr int DW_BK = 32;         // mma.sync: rows staged per step
constexpr int DW_S = DW_BM + 8;   // bf16 row stride: conflict-free ldmatrix
constexpr int DWF_THREADS = 256;  // f32 dW
constexpr int DWF_TS = 68;        // f32 dW: tile row stride (floats)
constexpr int DWF_X = (DW_STEP + 2) * DWF_TS, DWF_D = DW_STEP * DWF_TS;
constexpr int DWF_SMEM = 2 * (DWF_X + DWF_D) * 4;
constexpr int DWT_STAGES = 3;     // wgmma dW: 96 KB, two CTAs an SM
constexpr int DWT_BOX = DW_STEP * 128;  // 64 rows of 64 bf16 channels
constexpr int DWT_STAGE = 4 * DWT_BOX;  // three x boxes (the taps), dy
constexpr int DWT_THREADS = 160;        // a consumer warpgroup, a TMA warp
constexpr int DWT_SMEM = 1024 + DWT_STAGES * DWT_STAGE + 16 * DWT_STAGES;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Passes 2 and 4.  One CTA per (64-row tile, sample); channels along the
// threads (coalesced), and when Cout < 256 the threads' row groups split the
// tile's rows, their sums added in row-group order.  PARTIALS: part_a, part_b
// get the tile's sums of dh and dh x-hat; APPLY: dy is written and part_a
// gets the tile's sums of the f32 dy.
template <typename T, bool APPLY>
__global__ void __launch_bounds__(GRAD_THREADS)
k1b_gn_grad(const float* __restrict__ y, const T* __restrict__ dout,
            const float* __restrict__ g_mean, const float* __restrict__ g_rstd,
            const float* __restrict__ scale, const float* __restrict__ shift,
            const float* __restrict__ coef, float* __restrict__ part_a,
            float* __restrict__ part_b, T* __restrict__ dy, int B, int L,
            int Cout, int groups) {
  __shared__ float red_a[GRAD_THREADS], red_b[GRAD_THREADS];
  const int tile = blockIdx.x, b = blockIdx.y, n_tiles = gridDim.x;
  const int l0 = tile * BM, rows = min(BM, L - l0);
  const int cpt = min(Cout, GRAD_THREADS), n_rg = GRAD_THREADS / cpt;
  const int c0 = threadIdx.x % cpt, rg = threadIdx.x / cpt;
  const int cg = Cout / groups;
  for (int cb = 0; cb < Cout; cb += cpt) {
    const int c = cb + c0;
    float sa = 0.f, sb = 0.f;
    if (rg < n_rg && c < Cout) {
      const int gi = b * groups + c / cg;
      const float mu = g_mean[gi], rs = g_rstd[gi];
      const float sc = scale[c], sh = shift[c];
      const float ma = APPLY ? coef[gi] : 0.f;
      const float mb = APPLY ? coef[B * groups + gi] : 0.f;
#pragma unroll 4
      for (int r = rg; r < rows; r += n_rg) {
        const int64_t i = ((int64_t)b * L + l0 + r) * Cout + c;
        const float xh = (y[i] - mu) * rs;
        const float h = xh * sc + sh;
        const float s = 1.f / (1.f + expf(-h));
        const float dh = load_f(dout + i) * (s * (1.f + h * (1.f - s)));
        if constexpr (APPLY) {
          const float d = (dh * sc - ma - xh * mb) * rs;
          put(dy + i, d);
          sa += d;
        } else {
          sa += dh;
          sb += dh * xh;
        }
      }
    }
    red_a[threadIdx.x] = sa;
    red_b[threadIdx.x] = sb;
    __syncthreads();
    if (rg == 0 && c < Cout) {
      float ta = red_a[c0], tb = red_b[c0];
      for (int j = 1; j < n_rg; ++j) {
        ta += red_a[j * cpt + c0];
        tb += red_b[j * cpt + c0];
      }
      const int64_t p = ((int64_t)b * n_tiles + tile) * Cout + c;
      part_a[p] = ta;
      if constexpr (!APPLY) part_b[p] = tb;
    }
    __syncthreads();
  }
}

// out[b][c] = sum over t < T of in[b][t][c]: lane j of a column sums rows
// j, j + 8, j + 16, ... in order, then the eight lane sums are added in lane
// order.  One CTA per (32 columns, b).
__global__ void __launch_bounds__(SUM_LANES * 32)
k1b_sum_rows(const float* __restrict__ in, float* __restrict__ out, int T,
             int C) {
  __shared__ float red[SUM_LANES][32];
  const int j = threadIdx.x >> 5, cl = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + cl, b = blockIdx.y;
  float s = 0.f;
  if (c < C)
    for (int t = j; t < T; t += SUM_LANES) s += in[((int64_t)b * T + t) * C + c];
  red[j][cl] = s;
  __syncthreads();
  if (j == 0 && c < C) {
    float total = red[0][cl];
    for (int k = 1; k < SUM_LANES; ++k) total += red[k][cl];
    out[(int64_t)b * C + c] = total;
  }
}

// Per (sample, group): coef[0][b][g] = mean of dx-hat = dh scale and
// coef[1][b][g] = mean of dx-hat x-hat over the group's (L, Cout / groups),
// from the per-(sample, channel) sums of dh and dh x-hat, channels in order.
__global__ void __launch_bounds__(128)
k1b_group_coef(const float* __restrict__ s_dh, const float* __restrict__ s_dhx,
               const float* __restrict__ scale, float* __restrict__ coef,
               int B, int L, int Cout, int groups) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * groups) return;
  const int b = i / groups, g = i % groups, cg = Cout / groups;
  float a = 0.f, m = 0.f;
  for (int c = g * cg; c < (g + 1) * cg; ++c) {
    a += scale[c] * s_dh[(int64_t)b * Cout + c];
    m += scale[c] * s_dhx[(int64_t)b * Cout + c];
  }
  const float n = (float)L * (float)cg;
  coef[i] = a / n;
  coef[B * groups + i] = m / n;
}

// w_t[tap][co][ci] = W[2 - tap][ci][co]: dx's taps, in the (3, Cin, Cout)
// layout the conv pass reads with the channels swapped.
__global__ void __launch_bounds__(256)
k1b_flip_taps(const float* __restrict__ W, float* __restrict__ w_t, int Cin,
              int Cout) {
  const int64_t n = 3LL * Cin * Cout;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int ci = (int)(i % Cin);
    const int64_t r = i / Cin;
    const int co = (int)(r % Cout), tap = (int)(r / Cout);
    w_t[i] = W[((int64_t)(2 - tap) * Cin + ci) * Cout + co];
  }
}

// Eight bf16 channels [c, c + 8) of one row into a 16-byte word, zero past
// `n` (the row's channel count); one vector load when `vec`.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* row, int c, int n,
                                       int vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (vec) {
    if (c < n) v = *reinterpret_cast<const uint4*>(row + c);
  } else {
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (c + k < n) e[k] = row[c + k];
  }
  return v;
}

// dW's K = B L is cut into tiles of up to DW_STEP rows of one sample, in
// order (sample-major); CTA z sums the run of tiles [z T, z T + T) of the
// n_tiles, T = tiles_per_run.  The tiles of a run are consecutive rows of
// the flattened (B L) axis.
struct Run {
  int64_t begin, end;
  __device__ Run(int64_t n_tiles, int tiles_per_run)
      : begin((int64_t)blockIdx.z * tiles_per_run),
        end(begin + tiles_per_run < n_tiles ? begin + tiles_per_run
                                            : n_tiles) {}
};

// One CTA per (tap x 64 input channels, 64 output channels, run of tiles):
// the run's f32 partial of dW[tap][ci][co] = sum over rows (b, l) of
// x[b][l - 1 + tap][ci] dy[b][l][co] (zero past either end of a sample).
// The bf16 route for x that TMA cannot map (Cin % 8 != 0: the input block's
// 7 channels are 14-byte rows) or dy with Cout % 8 != 0.  Each step stages
// 32 rows of x (shifted by the tap) and of dy as [row][channel] tiles: both
// operands are M- / N-major there, so their fragments come through
// ldmatrix.trans.  Four warps, 2 x 2 over the 64 x 64 tile, on mma.sync
// m16n8k16.  The next step's rows are loaded into registers while this
// step's products run.
__global__ void __launch_bounds__(THREADS)
k1b_dw_bf16(const __nv_bfloat16* __restrict__ x,
            const __nv_bfloat16* __restrict__ dy, float* __restrict__ part,
            int L, int Cin, int Cout, int64_t n_tiles, int tiles_per_run,
            int vec_x, int vec_dy) {
  __shared__ __align__(16) __nv_bfloat16 xs[DW_BK][DW_S];
  __shared__ __align__(16) __nv_bfloat16 ds[DW_BK][DW_S];
  const int n_ci = (Cin + DW_BM - 1) / DW_BM;
  const int tap = blockIdx.x / n_ci, ci0 = (blockIdx.x % n_ci) * DW_BM;
  const int co0 = blockIdx.y * DW_BN;
  const Run rr(n_tiles, tiles_per_run);
  const int n_lt = (L + DW_STEP - 1) / DW_STEP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3, mat = lane >> 3, mrow = lane & 7;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // this thread's items of a step: rows j, channels [ch, ch + 8)
  constexpr int ITEMS = DW_BK * 8 / THREADS;
  constexpr int HALVES = DW_STEP / DW_BK;
  uint4 xv[ITEMS], dv[ITEMS];
  auto fetch = [&](int64_t step) {  // step HALVES t + h: rows h DW_BK .. of tile t
    const int64_t tile = step / HALVES, b = tile / n_lt;
    const int l0 = (int)(tile - b * n_lt) * DW_STEP + (int)(step % HALVES) * DW_BK;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int idx = tid + it * THREADS, j = idx >> 3, ch = (idx & 7) * 8;
      const int l = l0 + j;
      xv[it] = dv[it] = make_uint4(0u, 0u, 0u, 0u);
      if (l < L) {
        const int ls = l - 1 + tap;
        if (ls >= 0 && ls < L)
          xv[it] = load8(x + (b * L + ls) * Cin + ci0, ch, Cin - ci0, vec_x);
        dv[it] = load8(dy + (b * L + l) * Cout + co0, ch, Cout - co0, vec_dy);
      }
    }
  };
  const int64_t s_end = rr.end * HALVES;
  fetch(rr.begin * HALVES);
  for (int64_t step = rr.begin * HALVES; step < s_end; ++step) {
    __syncthreads();
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int idx = tid + it * THREADS, j = idx >> 3, ch = (idx & 7) * 8;
      *reinterpret_cast<uint4*>(&xs[j][ch]) = xv[it];
      *reinterpret_cast<uint4*>(&ds[j][ch]) = dv[it];
    }
    __syncthreads();
    if (step + 1 < s_end) fetch(step + 1);
#pragma unroll
    for (int kk = 0; kk < DW_BK; kk += 16) {
      uint32_t a[2][4], bq[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4_trans(a[mi], &xs[kk + (mat >> 1) * 8 + mrow]
                                [wm + mi * 16 + (mat & 1) * 8]);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4_trans(bq[np], &ds[kk + (mat & 1) * 8 + mrow]
                                 [wn + np * 16 + (mat >> 1) * 8]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], a[mi], &bq[ni >> 1][(ni & 1) * 2]);
    }
  }

  float* out = part + (int64_t)blockIdx.z * 3 * Cin * Cout;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = ci0 + wm + mi * 16 + g + 8 * (e >> 1);
        const int co = co0 + wn + ni * 8 + 2 * t + (e & 1);
        if (ci < Cin && co < Cout)
          out[((int64_t)tap * Cin + ci) * Cout + co] = acc[mi][ni][e];
      }
}

// The bf16 route on wgmma (Cin % 8 == 0, Cout % 8 == 0, x 16-byte
// aligned): one CTA per (64 input channels, 64 output channels, run of
// tiles), all three taps.  Warp 4 issues every TMA load into a ring of
// DWT_STAGES stages under full / empty mbarriers: per tile of 64 rows of one
// sample, three boxes of x (64 channels x 64 rows at rows l0 - 1, l0, l0 +
// 1, one a tap; L2 serves the repeats; TMA zero-fills rows outside the
// sample, so no tap reads the next sample) and one of dy (64 x 64 at l0),
// 128B-swizzled.  Warpgroup 0 runs dW[tap] += x_tap^T dy on wgmma
// m64n64k16 with both operands MN-major (channels contiguous, read through
// the descriptors' transpose bits: no transposed copy); each tile's 12
// products are issued before the previous tile's stage is released.
__global__ void __launch_bounds__(DWT_THREADS)
k1b_dw_tma(const __grid_constant__ CUtensorMap tm_x,
           const __grid_constant__ CUtensorMap tm_dy, float* __restrict__ part,
           int L, int Cin, int Cout, int64_t n_tiles, int tiles_per_run) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sS =
      smem_u32(smem_raw) + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sBar = sS + DWT_STAGES * DWT_STAGE;  // full[s], empty[s]
  const int ci0 = blockIdx.x * DW_BM, co0 = blockIdx.y * DW_BN;
  const Run rr(n_tiles, tiles_per_run);
  const int n_lt = (L + DW_STEP - 1) / DW_STEP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = (int)(rr.end - rr.begin);
  if (threadIdx.x == 0) {
    for (int s = 0; s < DWT_STAGES; ++s) {
      mbar_init(sBar + 8 * s, 1);
      mbar_init(sBar + 8 * (DWT_STAGES + s), 4);  // the 4 consumer warps
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {
    if (lane == 0)
      for (int it = 0; it < n; ++it) {
        const int s = it % DWT_STAGES;
        const uint32_t full = sBar + 8 * s, st = sS + s * DWT_STAGE;
        const int64_t tile = rr.begin + it, b = tile / n_lt;
        const int l0 = (int)(tile - b * n_lt) * DW_STEP;
        mbar_wait(sBar + 8 * (DWT_STAGES + s), ((it / DWT_STAGES) & 1) ^ 1);
        mbar_expect_tx(full, DWT_STAGE);
        for (int tap = 0; tap < 3; ++tap)
          tma_load_3d(st + tap * DWT_BOX, &tm_x, full, ci0, l0 - 1 + tap,
                      (int)b);
        tma_load_3d(st + 3 * DWT_BOX, &tm_dy, full, co0, l0, (int)b);
      }
    return;
  }
  float acc[3][32];
#pragma unroll
  for (int tap = 0; tap < 3; ++tap)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[tap][i] = 0.f;
  for (int it = 0; it < n; ++it) {
    const int s = it % DWT_STAGES;
    const uint32_t st = sS + s * DWT_STAGE;
    mbar_wait(sBar + 8 * s, (it / DWT_STAGES) & 1);
#pragma unroll
    for (int tap = 0; tap < 3; ++tap) fence_regs<32>(acc[tap]);
    wgmma_fence();
    const uint64_t db = smem_desc_mn(st + 3 * DWT_BOX, DWT_BOX);
#pragma unroll
    for (int tap = 0; tap < 3; ++tap) {
      const uint64_t da = smem_desc_mn(st + tap * DWT_BOX, DWT_BOX);
#pragma unroll
      for (int ks = 0; ks < DW_STEP / 16; ++ks)  // 16 rows, 2048 bytes a step
        wgmma_bf16_tt64(acc[tap], da + (uint64_t)(ks * 128),
                        db + (uint64_t)(ks * 128));
    }
    wgmma_commit();
    if (it > 0) {
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(sBar + 8 * (DWT_STAGES + (it - 1) % DWT_STAGES));
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int tap = 0; tap < 3; ++tap) fence_regs<32>(acc[tap]);
  // accumulator element i: input channel 16 warp + g + 8 ((i >> 1) & 1),
  // output channel 8 (i >> 2) + 2 t + (i & 1); Cout % 8 == 0 keeps pairs
  // whole
  const int g = lane >> 2, t = lane & 3;
  float* out = part + (int64_t)blockIdx.z * 3 * Cin * Cout;
#pragma unroll
  for (int tap = 0; tap < 3; ++tap)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int ci = ci0 + 16 * warp + g + 8 * ((i >> 1) & 1);
      const int co = co0 + 8 * (i >> 2) + 2 * t;
      if (ci < Cin && co < Cout)
        *reinterpret_cast<float2*>(out + ((int64_t)tap * Cin + ci) * Cout + co) =
            make_float2(acc[tap][i], acc[tap][i + 1]);
    }
}

// The same partials in f32 on the FMA units (no TF32): one CTA per (64
// input channels, 64 output channels, run of tiles), all three taps.  Each
// tile stages x rows l0 - 1 .. l0 + 64 and dy rows l0 .. l0 + 63 as
// [row][68] floats, double-buffered through cp.async; thread (tx, ty) of
// 16 x 16 owns input channels ci0 + 4 ty + i and output channels co0 + 4 tx
// + j of each tap: per row four float4 reads for 48 FMAs.
__global__ void __launch_bounds__(DWF_THREADS)
k1b_dw_f32(const float* __restrict__ x, const float* __restrict__ dy,
           float* __restrict__ part, int L, int Cin, int Cout,
           int64_t n_tiles, int tiles_per_run, int vec_x, int vec_dy) {
  extern __shared__ __align__(16) float dwf_smem[];
  float* xs = dwf_smem;           // two stages
  float* ds = xs + 2 * DWF_X;     // two stages
  const int ci0 = blockIdx.x * DW_BM, co0 = blockIdx.y * DW_BN;
  const Run rr(n_tiles, tiles_per_run);
  const int n_lt = (L + DW_STEP - 1) / DW_STEP;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // rows l0 + r0 .. of sample b (n of them) into the [n][DWF_TS] tile at
  // dst: channels c0 .. c0 + 63 of C, zero outside [0, L) and past C
  auto stage = [&](uint32_t dst, const float* src, int64_t b, int l_first,
                   int n_rows, int c0, int C, int vec) {
    if (vec) {
      for (int idx = threadIdx.x; idx < n_rows * 16; idx += DWF_THREADS) {
        const int r = idx >> 4, c = (idx & 15) * 4, l = l_first + r;
        const bool ok = l >= 0 && l < L && c0 + c < C;
        cp_async16(dst + (r * DWF_TS + c) * 4,
                   ok ? src + (b * L + l) * C + c0 + c : src, ok);
      }
    } else {
      for (int idx = threadIdx.x; idx < n_rows * 64; idx += DWF_THREADS) {
        const int r = idx >> 6, c = idx & 63, l = l_first + r;
        const bool ok = l >= 0 && l < L && c0 + c < C;
        cp_async4(dst + (r * DWF_TS + c) * 4,
                  ok ? src + (b * L + l) * C + c0 + c : src, ok);
      }
    }
  };
  auto load = [&](int64_t tile, int s) {
    const int64_t b = tile / n_lt;
    const int l0 = (int)(tile - b * n_lt) * DW_STEP;
    stage(smem_u32(xs + s * DWF_X), x, b, l0 - 1, DW_STEP + 2, ci0, Cin, vec_x);
    stage(smem_u32(ds + s * DWF_D), dy, b, l0, DW_STEP, co0, Cout, vec_dy);
    cp_async_commit();
  };
  float acc[3][4][4];
#pragma unroll
  for (int tap = 0; tap < 3; ++tap)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[tap][i][j] = 0.f;
  load(rr.begin, 0);
  for (int64_t tile = rr.begin; tile < rr.end; ++tile) {
    const int s = (int)((tile - rr.begin) & 1);
    if (tile + 1 < rr.end) {
      load(tile + 1, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* X = xs + s * DWF_X;
    const float* Dy = ds + s * DWF_D;
#pragma unroll 4
    for (int r = 0; r < DW_STEP; ++r) {
      const float4 bv = *reinterpret_cast<const float4*>(Dy + r * DWF_TS + 4 * tx);
      const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int tap = 0; tap < 3; ++tap) {
        const float4 av =
            *reinterpret_cast<const float4*>(X + (r + tap) * DWF_TS + 4 * ty);
        const float ai[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[tap][i][j] = fmaf(ai[i], bj[j], acc[tap][i][j]);
      }
    }
    __syncthreads();
  }

  float* out = part + (int64_t)blockIdx.z * 3 * Cin * Cout;
#pragma unroll
  for (int tap = 0; tap < 3; ++tap)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ci = ci0 + 4 * ty + i, co = co0 + 4 * tx + j;
        if (ci < Cin && co < Cout)
          out[((int64_t)tap * Cin + ci) * Cout + co] = acc[tap][i][j];
      }
}

cudaError_t sum_rows(const float* in, float* out, int nb, int T, int64_t C,
                     cudaStream_t st) {
  k1b_sum_rows<<<dim3((unsigned)((C + 31) / 32), nb), SUM_LANES * 32, 0,
                 st>>>(in, out, T, (int)C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t gn_grad(const float* y, const void* dout, const float* g_mean,
                    const float* g_rstd, const float* scale,
                    const float* shift, const float* coef, float* part_a,
                    float* part_b, void* dy, int B, int L, int Cout,
                    int groups, bool apply, cudaStream_t st) {
  const dim3 grid((L + BM - 1) / BM, B);
  const T* d = static_cast<const T*>(dout);
  if (apply)
    k1b_gn_grad<T, true><<<grid, GRAD_THREADS, 0, st>>>(
        y, d, g_mean, g_rstd, scale, shift, coef, part_a, part_b,
        static_cast<T*>(dy), B, L, Cout, groups);
  else
    k1b_gn_grad<T, false><<<grid, GRAD_THREADS, 0, st>>>(
        y, d, g_mean, g_rstd, scale, shift, coef, part_a, part_b, nullptr, B,
        L, Cout, groups);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* conv_gn_silu_backward_error_string(int code) {
  return error_string(code);
}

// Rows per partial tile (the scratch part_a / part_b is (B, ceil(L / 64),
// Cout)) and per dW tile (up to that many rows of one sample; a run of dW
// is a multiple of it).
int conv_gn_silu_backward_rows_per_tile(void) { return BM; }
int conv_gn_silu_backward_rows_per_step(void) { return DW_STEP; }

// dout, x (B, L, Cout / Cin) in x's dtype (f32: route 0; bf16: route 1 or 2,
// as the forward), W (3, Cin, Cout), bias, gn_scale, gn_bias f32.  Outputs:
// dx (B, L, Cin) in x's dtype, dW (3, Cin, Cout), db, dscale, dbias (Cout)
// f32.  Scratch: y (B, L, Cout) f32; part_a, part_b (B, ceil(L / 64), Cout)
// f32; g_mean, g_rstd (B, groups) f32; sums (3, B, Cout) f32; coef (2, B,
// groups) f32; dy (B, L, Cout) in x's dtype, 16-byte aligned; w_t (3, Cout,
// Cin) f32; for route 2 w_packed (Cout_pad, 3, Cin_pad) bf16, for dx_route
// 2 wt_packed (Cin_pad, 3, Cout_pad) bf16 (pads rounded up to 64); dw_part
// (n_runs, 3, Cin, Cout) f32, n_runs = ceil(B ceil(L / 64) / (dw_run / 64)),
// dw_run a multiple of 64 (rows a run, in whole tiles).  dx_route
// is the conv route for dy (2 needs bf16 and Cout % 8 == 0).  All
// contiguous on the current device.  Launches on `stream`, does not
// synchronise, returns the first launch error (0 on success).
int conv_gn_silu_backward(const void* dout, const void* x, const float* W,
                          const float* bias, const float* gn_scale,
                          const float* gn_bias, void* dx, float* dW,
                          float* db, float* dscale, float* dbias, float* y,
                          float* part_a, float* part_b, float* g_mean,
                          float* g_rstd, float* sums, float* coef, void* dy,
                          float* w_t, void* w_packed, void* wt_packed,
                          float* dw_part, int B, int L, int Cin, int Cout,
                          int groups, float eps, int route, int dx_route,
                          int dw_run, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dw_run < DW_STEP || dw_run % DW_STEP) return cudaErrorInvalidValue;
  const int n_tiles = (L + BM - 1) / BM;
  const bool bf = route != ROUTE_FMA;
  float* s_dh = sums;
  float* s_dhx = sums + (int64_t)B * Cout;
  float* s_db = sums + 2 * (int64_t)B * Cout;
  int rc = conv_y_stats(x, W, bias, y, part_a, part_b, g_mean, g_rstd,
                        w_packed, B, L, Cin, Cout, groups, eps, route, st);
  if (rc != 0) return rc;
  cudaError_t e;
#define K1B_TRY(call)              \
  if ((e = (call)) != cudaSuccess) \
    return e;
  K1B_TRY((bf ? gn_grad<__nv_bfloat16> : gn_grad<float>)(
      y, dout, g_mean, g_rstd, gn_scale, gn_bias, nullptr, part_a, part_b,
      nullptr, B, L, Cout, groups, false, st));
  K1B_TRY(sum_rows(part_a, s_dh, B, n_tiles, Cout, st));
  K1B_TRY(sum_rows(part_b, s_dhx, B, n_tiles, Cout, st));
  K1B_TRY(sum_rows(s_dh, dbias, 1, B, Cout, st));
  K1B_TRY(sum_rows(s_dhx, dscale, 1, B, Cout, st));
  k1b_group_coef<<<(B * groups + 127) / 128, 128, 0, st>>>(
      s_dh, s_dhx, gn_scale, coef, B, L, Cout, groups);
  K1B_TRY(cudaGetLastError());
  K1B_TRY((bf ? gn_grad<__nv_bfloat16> : gn_grad<float>)(
      y, dout, g_mean, g_rstd, gn_scale, gn_bias, coef, part_a, nullptr, dy,
      B, L, Cout, groups, true, st));
  K1B_TRY(sum_rows(part_a, s_db, B, n_tiles, Cout, st));
  K1B_TRY(sum_rows(s_db, db, 1, B, Cout, st));

  const int64_t n_w = 3LL * Cin * Cout;
  const int64_t flip_ctas = (n_w + 255) / 256;
  k1b_flip_taps<<<(unsigned)(flip_ctas < 4096 ? flip_ctas : 4096), 256, 0,
                  st>>>(W, w_t, Cin, Cout);
  K1B_TRY(cudaGetLastError());
  rc = conv_dx(dy, w_t, wt_packed, dx, B, L, Cout, Cin, dx_route, st);
  if (rc != 0) return rc;

  const int64_t dw_tiles = (int64_t)B * ((L + DW_STEP - 1) / DW_STEP);
  const int per_run = dw_run / DW_STEP;
  const int n_runs = (int)((dw_tiles + per_run - 1) / per_run);
  const int n_ci = (Cin + DW_BM - 1) / DW_BM, n_co = (Cout + DW_BN - 1) / DW_BN;
  if (bf && route == ROUTE_WGMMA && dx_route == ROUTE_WGMMA) {
    CUtensorMap tmx, tmdy;
    const cuuint64_t x_dims[3] = {(cuuint64_t)Cin, (cuuint64_t)L, (cuuint64_t)B};
    const cuuint64_t x_strides[2] = {(cuuint64_t)Cin * 2, (cuuint64_t)L * Cin * 2};
    const cuuint64_t d_dims[3] = {(cuuint64_t)Cout, (cuuint64_t)L, (cuuint64_t)B};
    const cuuint64_t d_strides[2] = {(cuuint64_t)Cout * 2,
                                     (cuuint64_t)L * Cout * 2};
    const cuuint32_t box[3] = {DW_BM, DW_STEP, 1};
    if (!encode_bf16(&tmx, x, 3, x_dims, x_strides, box) ||
        !encode_bf16(&tmdy, dy, 3, d_dims, d_strides, box))
      return ERR_TENSOR_MAP;
    K1B_TRY(cudaFuncSetAttribute(k1b_dw_tma,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 DWT_SMEM));
    k1b_dw_tma<<<dim3(n_ci, n_co, n_runs), DWT_THREADS, DWT_SMEM, st>>>(
        tmx, tmdy, dw_part, L, Cin, Cout, dw_tiles, per_run);
  } else if (bf) {
    const int vec_x = Cin % 8 == 0 && (uintptr_t)x % 16 == 0;
    k1b_dw_bf16<<<dim3(3 * n_ci, n_co, n_runs), THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(dy), dw_part, L, Cin, Cout,
        dw_tiles, per_run, vec_x, Cout % 8 == 0);
  } else {
    K1B_TRY(cudaFuncSetAttribute(k1b_dw_f32,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 DWF_SMEM));
    k1b_dw_f32<<<dim3(n_ci, n_co, n_runs), DWF_THREADS, DWF_SMEM, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), dw_part,
        L, Cin, Cout, dw_tiles, per_run,
        Cin % 4 == 0 && (uintptr_t)x % 16 == 0, Cout % 4 == 0);
  }
  K1B_TRY(cudaGetLastError());
  K1B_TRY(sum_rows(dw_part, dW, 1, n_runs, n_w, st));
#undef K1B_TRY
  return 0;
}

}  // extern "C"
