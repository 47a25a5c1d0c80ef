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
// The device code is in conv_gn_silu.cuh, which the backward
// (conv_gn_silu_backward.cu) shares.
#include "conv_gn_silu.cuh"

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

}  // extern "C"
