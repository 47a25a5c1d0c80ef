// Fused ConvBlock for Hopper (sm_90a): conv1d(k=3, SAME) + bias -> GroupNorm
// -> affine -> SiLU on channels-last (B, L, C) activations.
//
// Replaces the Pallas TPU kernel
// diffusion_models_for_gravitational_waveform_reconstruction_tpu/ops/pallas/fused.py::fused_conv_gn_silu
// (body _conv_gn_silu_kernel).  Same function: the k=3 conv is one im2col
// product [x_{l-1} | x_l | x_{l+1}] @ W(3Cin, Cout) with operands in the input
// dtype and f32 accumulation, plus bias; GroupNorm statistics over (L, Cout/G)
// per sample; eps inside the square root; output in the input dtype.
//
// The TPU kernel keeps one whole (L, Cout) sample in VMEM; one Hopper CTA
// cannot hold that at L = 4096, Cout = 512, so the block runs in passes:
//   conv   - y = conv + bias in f32 to a scratch tensor, and per (64-row tile,
//            channel) the exact two-pass mean and M2 of the tile's rows;
//   group_stats - one CTA per (group, sample) merges those partials with
//            Chan's pairwise (count, mean, M2) update in a fixed order (no
//            float atomics: deterministic, and no cancellation the way
//            E[y^2] - mean^2 cancels when |mean| >> std);
//   gn_affine_silu - normalise, affine, SiLU, then the epilogue if asked
//            for (the U-Net's conditioning bias and FiLM), cast.
//
// What bounds each pass on the H100, and what the design does about it.
//   conv, bf16: 2 * L * 3 * Cin * Cout FLOPs per sample on operands read
//     once, 100-1500 FLOP per byte at the U-Nets' shapes, so the tensor-core
//     rate (989 TFLOP/s dense) bounds it.  Only wgmma reaches that rate, so
//     for Cin % 8 == 0 (TMA needs x's rows on 16-byte strides) the conv is an
//     implicit GEMM on wgmma (conv3_wgmma_bf16): M = a 128-row L tile of one
//     sample (two consumer warpgroups of 64 rows), N = a 64- or 128-channel
//     Cout tile, K = 3 taps x Cin padded to 64-channel chunks, walked as
//     (chunk, tap).  A producer warp keeps a ring of 128B-swizzled stages full
//     with TMA: per (chunk, tap) the A tile is rows l0-1+tap .. l0+126+tap of
//     x through a 3-D tensor map over (Cin, L, B), whose out-of-bounds zero
//     fill at row -1 and row L is the SAME padding and never reaches the
//     neighbouring sample; the B tile comes from the weights packed once per
//     call (pack_weights_bf16: f32 (3, Cin, Cout) -> bf16
//     [Cout_pad][3][Cin_pad], K-major, zero-padded), so no CTA converts
//     weights.  The three taps re-read x's rows from L2.  The epilogue adds
//     the bias, stores y from the accumulator registers and reduces each
//     channel's (mean, M2) over the valid rows of each warpgroup's 64 rows
//     (shuffles across the row lanes, then the four warps in a fixed order
//     through shared memory); rows past L are left out of both.
//     The other bf16 route (conv3_bias_stats_bf16, mma.sync m16n8k16) takes
//     Cin % 8 != 0 (the 7-channel input block) or an x that is not 16-byte
//     aligned: it stages zero-padded halo rows in shared memory.
//   conv, f32: the FP32 FMA rate (67 TFLOP/s) bounds it; conv3_bias_stats_f32
//     (FMA, no TF32) serves the f32 parity runs, not the bf16 serving path.
//   y's round trip: the two-pass design writes and reads y in f32, 8 bytes
//     per output element beyond the bound's x + W + output; keeping y out of
//     device memory (single-pass K1) is later work.
//   gn_affine_silu: bytes-bound (y read, output written).  One CTA per
//     (sample, run of rows) with channels along the threads: each thread
//     holds its channels' (mean, rstd * scale, shift) in registers and walks
//     rows with 16-byte y loads and 8-byte bf16 (16-byte f32) stores.
//     Its epilogue is what follows each ConvBlock of the U-Net at
//     inference, so that the activation is written once instead of read and
//     written again by each of those steps: with `film` (B, 2 Cout) =
//     [gamma | beta] and, for the conditioning bias, the stage-length
//     conditioning r (B, L, K), both in x's dtype, and the bias's Dense
//     wc (K, Cout), bc (Cout,) f32, out = (s + bc + r wc) (1 + gamma) +
//     beta for s = silu(gn(y)), all in f32 and rounded once (without r,
//     out = s (1 + gamma) + beta).  A thread also holds its channels'
//     1 + gamma, beta and bc in registers; each CTA stages wc and the K
//     values of its rows of r in f32 in shared memory, one broadcast read
//     per row and K.  The pass stays bytes-bound: 2 K bytes a row (10 at
//     K 5) beside 6 Cout bytes of y and output; its registers are held to
//     64 (4 CTAs an SM) to keep the loads in flight.  On an H100 the 7
//     blocks of a pn128 forward at 128 rows took 4.6 ms with the epilogue,
//     4.1-4.4 ms without it, and 9.5 ms with the bias and FiLM as separate
//     PyTorch steps.
//
// The decoder route (conv_gn_silu_decoder_forward): the U-Net's decoder
// block, conv3([nearest_up2(h) | skip]) -> GN -> SiLU (+ the epilogue),
// with h (B, L/2, C_h) and skip (B, L, C_s) read as two sources, so the
// upsampled and the concatenated tensors are never written.  It is K1's
// decoder variant of the same Pallas kernel, computing the fold of JAX's
// DecoderConvBlock (models/unet.py), which the Pallas kernel never takes.
// What bounds it: the materialised path's conv pass did 6 C_h Cout MACs a
// row for h's part, on an upsampled input that a repeat and a concatenation
// wrote and read again (2 bytes a channel for each write and read at full
// length, more than the conv's own reads); the device-memory rate bound
// those copies.  The design: conv3_wgmma_decoder_bf16 loads h's rows at
// half length and skip's rows through two tensor maps; the upsample folds
// into h's taps (out[2j] = W0 h[j-1] + (W1 + W2) h[j], out[2j+1] = (W0 +
// W1) h[j] + W2 h[j+1]), 4 C_h Cout MACs a row; a CTA takes 128 output
// rows of one parity, so both warpgroups share each stage's weight tile
// (the folded taps differ between the parities) and the ring and its 2
// CTAs an SM stay the plain route's.  pack_weights_decoder_bf16 sums the
// folded taps in f32 and rounds them once.  y's rows are stored at stride
// 2; each warpgroup's partial statistics cover its 64 rows of one parity,
// and group_stats counts those tiles' rows from L / 2.  The tensor-core
// rate bounds the conv pass as on the plain route.
//
// The device code the backward (conv_gn_silu_backward.cu) shares is in
// conv_gn_silu.cuh; the decoder route's own kernels and launch follow.
#include "conv_gn_silu.cuh"

namespace {

// K1's decoder route (DEC above): tmap_h over h (C_h, L/2, B), tmap_s over
// skip seen as (2 C_s, L/2, B), tmap_w over the decoder pack; L is the
// output's length, n_tiles = 2 ceil(L / 128) partial tiles a sample.
template <int TN>
__global__ void __launch_bounds__(WG_THREADS, 2)
conv3_wgmma_decoder_bf16(const __grid_constant__ CUtensorMap tmap_h,
                         const __grid_constant__ CUtensorMap tmap_s,
                         const __grid_constant__ CUtensorMap tmap_w,
                         const float* __restrict__ bias, float* __restrict__ y,
                         float* __restrict__ part_mean,
                         float* __restrict__ part_m2, int L, int Cout,
                         int n_chunks_h, int n_chunks_s, int n_tiles) {
  conv3_wgmma_body<TN, false, true>(&tmap_h, &tmap_s, &tmap_w, bias, y,
                                    part_mean, part_m2, nullptr, L, Cout,
                                    n_chunks_h, n_chunks_s, n_tiles);
}

// The decoder route's pack: W (3, C_h + C_s, Cout) f32 -> Wp [Cout_pad][K]
// bf16, K = 4 C_h + 3 C_s, K-major: first the four folded taps of the h
// part, v = 2p + u = W0 | W1 + W2 | W0 + W1 | W2 over W's first C_h rows,
// each pair summed in f32 and rounded to bf16 once, then the three taps of
// the skip part (W's last C_s rows).  Rows Cout .. Cout_pad are zeros.  One
// CTA per 32 x 32 tile of one of the 7 parts, as pack_weights_bf16.
__global__ void __launch_bounds__(256)
pack_weights_decoder_bf16(const float* __restrict__ W,
                          __nv_bfloat16* __restrict__ Wp, int Ch, int Cs,
                          int Cout) {
  __shared__ float tile[PACK_TILE][PACK_TILE + 1];
  const int v = blockIdx.z, ci0 = blockIdx.y * PACK_TILE;
  const int co0 = blockIdx.x * PACK_TILE;
  if (ci0 >= (v < 4 ? Ch : Cs)) return;
  const int Cin = Ch + Cs, K = 4 * Ch + 3 * Cs;
  // the taps t_lo .. t_hi summed into part v, W's first row of the part,
  // its K offset
  const int fold_lo[4] = {0, 1, 0, 2}, fold_hi[4] = {0, 2, 1, 2};
  const int t_lo = v < 4 ? fold_lo[v] : v - 4;
  const int t_hi = v < 4 ? fold_hi[v] : v - 4;
  const int row0 = v < 4 ? 0 : Ch;
  const int k0 = v < 4 ? v * Ch : 4 * Ch + (v - 4) * Cs;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i = ty; i < PACK_TILE; i += 8) {
    const int ci = row0 + ci0 + i, co = co0 + tx;
    float a = 0.f;
    if (co < Cout)
      for (int t = t_lo; t <= t_hi; ++t)
        a += W[((int64_t)t * Cin + ci) * Cout + co];
    tile[i][tx] = a;
  }
  __syncthreads();
  for (int i = ty; i < PACK_TILE; i += 8) {
    const int co = co0 + i, ci = ci0 + tx;
    Wp[(int64_t)co * K + k0 + ci] = __float2bfloat16(tile[tx][i]);
  }
}

// The decoder route's conv pass on the tile width TN: the three tensor
// maps, then conv3_wgmma_decoder_bf16 over 2 ceil(L / 256) parity tiles of
// 128 rows a sample and Cout / TN channel tiles.
template <int TN>
int launch_wgmma_decoder(const __nv_bfloat16* h, const __nv_bfloat16* skip,
                         const __nv_bfloat16* Wp, const float* bias, float* y,
                         float* part_mean, float* part_m2, int B, int L,
                         int Ch, int Cs, int Cout, int n_tiles,
                         cudaStream_t st) {
  const int cout_pad = (Cout + KCH - 1) / KCH * KCH;
  const int K = 4 * Ch + 3 * Cs, Lh = L / 2;
  CUtensorMap tmh, tms, tmw;
  const cuuint64_t h_dims[3] = {(cuuint64_t)Ch, (cuuint64_t)Lh, (cuuint64_t)B};
  const cuuint64_t h_strides[2] = {(cuuint64_t)Ch * 2,
                                   (cuuint64_t)Lh * Ch * 2};
  // skip (B, L, C_s) seen as (B, L/2, 2 C_s)
  const cuuint64_t s_dims[3] = {(cuuint64_t)2 * Cs, (cuuint64_t)Lh,
                                (cuuint64_t)B};
  const cuuint64_t s_strides[2] = {(cuuint64_t)4 * Cs,
                                   (cuuint64_t)Lh * Cs * 4};
  const cuuint32_t x_box[3] = {KCH, WM, 1};
  const cuuint64_t w_dims[2] = {(cuuint64_t)K, (cuuint64_t)cout_pad};
  const cuuint64_t w_strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t w_box[2] = {KCH, TN};
  if (!encode_bf16(&tmh, h, 3, h_dims, h_strides, x_box) ||
      !encode_bf16(&tms, skip, 3, s_dims, s_strides, x_box) ||
      !encode_bf16(&tmw, Wp, 2, w_dims, w_strides, w_box))
    return ERR_TENSOR_MAP;
  cudaError_t e = cudaFuncSetAttribute(
      conv3_wgmma_decoder_bf16<TN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, WgCfg<TN>::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((Cout + TN - 1) / TN, 2 * ((Lh + WM - 1) / WM), B);
  conv3_wgmma_decoder_bf16<TN><<<grid, WG_THREADS, WgCfg<TN>::SMEM, st>>>(
      tmh, tms, tmw, bias, y, part_mean, part_m2, L, Cout, Ch / KCH,
      Cs / KCH, n_tiles);
  return cudaGetLastError();
}

// The decoder route's first two passes: the decoder pack into w_packed
// (Cout_pad, 4 C_h + 3 C_s) bf16, y = conv3([nearest_up2(h) | skip]) + bias
// in f32 with its partials (h (B, L/2, C_h) and skip (B, L, C_s) bf16,
// 16-byte aligned, C_h and C_s multiples of 64), then the group statistics
// over its 2 ceil(L / 128) interleaved tiles.
inline int decoder_y_stats(const __nv_bfloat16* h, const __nv_bfloat16* skip,
                           const float* W, const float* bias, float* y,
                           float* part_mean, float* part_m2, float* g_mean,
                           float* g_rstd, __nv_bfloat16* Wp, int B, int L,
                           int Ch, int Cs, int Cout, int groups, float eps,
                           cudaStream_t st) {
  const int cout_pad = (Cout + KCH - 1) / KCH * KCH;
  pack_weights_decoder_bf16<<<dim3(cout_pad / PACK_TILE,
                                   (Ch > Cs ? Ch : Cs) / PACK_TILE, 7),
                              256, 0, st>>>(W, Wp, Ch, Cs, Cout);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n_tiles = 2 * ((L + 2 * BM - 1) / (2 * BM));
  const int rc =
      Cout > 64 ? launch_wgmma_decoder<128>(h, skip, Wp, bias, y, part_mean,
                                            part_m2, B, L, Ch, Cs, Cout,
                                            n_tiles, st)
                : launch_wgmma_decoder<64>(h, skip, Wp, bias, y, part_mean,
                                           part_m2, B, L, Ch, Cs, Cout,
                                           n_tiles, st);
  if (rc != 0) return rc;
  group_stats<<<dim3(groups, B), STATS_THREADS, 0, st>>>(
      part_mean, part_m2, g_mean, g_rstd, L, Cout, groups, n_tiles, eps, 1);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of L per partial-statistics tile: the wrapper sizes the scratch
// (B, ceil(L / rows), Cout) with it.
int conv_gn_silu_rows_per_tile(void) { return BM; }

// Channels per K chunk of the packed weights: Cin and Cout are padded to it.
int conv_gn_silu_pack_chunk(void) { return KCH; }

const char* conv_gn_silu_error_string(int code) {
  return error_string(code);
}

// x (B, L, Cin) f32 (route 0, FMA) or bf16 (route 1, mma.sync; route 2,
// wgmma: Cin % 8 == 0 and x 16-byte aligned); W (3, Cin, Cout), bias,
// gn_scale, gn_bias f32; out (B, L, Cout) in x's dtype; scratch y (B, L,
// Cout) f32, part_mean and part_m2 (B, ceil(L / 64), Cout) f32, g_mean and
// g_rstd (B, groups) f32, and for route 2 w_packed (Cout_pad, 3, Cin_pad)
// bf16 with both pads rounded up to 64.  The epilogue: film (B, 2 Cout) in
// x's dtype, or null for none; r (B, L, K) in x's dtype, wc (K, Cout) and
// bc (Cout,) f32, or r null for FiLM alone.  All contiguous on the current
// device.  Launches on `stream`, does not synchronise, returns the first
// launch error (0 on success).
int conv_gn_silu_forward(const void* x, const float* W, const float* bias,
                         const float* gn_scale, const float* gn_bias,
                         void* out, float* y, float* part_mean, float* part_m2,
                         float* g_mean, float* g_rstd, void* w_packed,
                         const void* film, const void* r, const float* wc,
                         const float* bc, int B, int L, int Cin, int Cout,
                         int groups, int K, float eps, int route,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = conv_y_stats(x, W, bias, y, part_mean, part_m2, g_mean,
                              g_rstd, w_packed, B, L, Cin, Cout, groups, eps,
                              route, st);
  if (rc != 0) return rc;
  const Epilogue ep{film, r, wc, bc, K};
  if (route == ROUTE_FMA)
    return launch_apply<float>(y, g_mean, g_rstd, gn_scale, gn_bias,
                               static_cast<float*>(out), B, L, Cout, groups,
                               ep, st);
  return launch_apply<__nv_bfloat16>(y, g_mean, g_rstd, gn_scale, gn_bias,
                                     static_cast<__nv_bfloat16*>(out), B, L,
                                     Cout, groups, ep, st);
}

// The decoder route: out = K1(concat(nearest_up2(h), skip)) without either
// tensor.  h (B, L/2, Ch) and skip (B, L, Cs) bf16, 16-byte aligned, Ch and
// Cs multiples of 64; L even; W (3, Ch + Cs, Cout) and the rest as for
// conv_gn_silu_forward's wgmma route, out (B, L, Cout) bf16, part_mean and
// part_m2 (B, 2 ceil(L / 128), Cout) f32, w_packed (Cout_pad, 4 Ch + 3 Cs)
// bf16.  Launches on `stream`, returns the first launch error.
int conv_gn_silu_decoder_forward(
    const void* h, const void* skip, const float* W, const float* bias,
    const float* gn_scale, const float* gn_bias, void* out, float* y,
    float* part_mean, float* part_m2, float* g_mean, float* g_rstd,
    void* w_packed, const void* film, const void* r, const float* wc,
    const float* bc, int B, int L, int Ch, int Cs, int Cout, int groups,
    int K, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = decoder_y_stats(
      static_cast<const __nv_bfloat16*>(h),
      static_cast<const __nv_bfloat16*>(skip), W, bias, y, part_mean,
      part_m2, g_mean, g_rstd, static_cast<__nv_bfloat16*>(w_packed), B, L,
      Ch, Cs, Cout, groups, eps, st);
  if (rc != 0) return rc;
  const Epilogue ep{film, r, wc, bc, K};
  return launch_apply<__nv_bfloat16>(y, g_mean, g_rstd, gn_scale, gn_bias,
                                     static_cast<__nv_bfloat16*>(out), B, L,
                                     Cout, groups, ep, st);
}

}  // extern "C"
