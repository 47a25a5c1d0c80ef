// The U-Net's head for Hopper (sm_90a): conv1d(k=3, SAME) of the last
// decoder output h and the noisy sample x_t to one output channel, read in
// place.
//
//   out[b, l] = bias + sum_{k=0..2} ( sum_c W[k, c] h[b, l+k-1, c]
//                                     + W[k, C] x_t[b, l+k-1] )
//
// It replaces no Pallas TPU kernel: the JAX package's head
// (diffusion_models_for_gravitational_waveform_reconstruction_tpu/models/unet.py:396-401,
// the final nn.Conv on [h | x_t]) is left to XLA there.  In the port it was
// a concatenation of h with x_t at C + 1 channels, an im2col of three
// shifted copies of that at 3 (C + 1), a matrix-vector product and a bias
// add: about 1.75 GB of traffic and 8 launches for a pn128 forward (128
// rows, L 4096, C 128) whose work is one 3-tap dot product a row.
//
// h is (B, L_h, C) channels-last; x_t is channel 0 of the network input x
// (B, L0, C_in), read at stride C_in.  Rows outside [0, L0) are the SAME
// padding; rows of h at or past L_h are zero, which is the U-Net's fix_len
// pad and crop of h to L0.  W is the head's f32 kernel (3, C + 1) (flax
// layout (3, C + 1, 1)), rounded here to the compute dtype as the model
// rounds it; the products accumulate in f32, the f32 bias is added, and
// the sum is rounded once to the compute dtype, then widened: out (B, L0)
// f32, the model's (B, 1, L0).
//
// What bounds it on the H100: about 0.5 FLOP a byte, so device memory.  At
// pn128's shape h is 134 MB, x 7 MB and out 2 MB: about 43 us at 3.35 TB/s;
// attn16k's (64 rows, L 32768, C 64) 268 + 29 + 8 MB, about 91 us.  The
// design reads h once, in 16-byte vectors with neighbouring lanes on
// neighbouring addresses, on CUDA cores (no tensor cores, no TMA: a tensor
// map a call would cost host time on a path whose host is close behind its
// device):
//   - a CTA takes one sample and a tile of TILE output rows, so it reads
//     TILE + 2 rows of h (a one-row halo on each side: 2 / TILE re-read);
//   - a group of G lanes (a power of two, up to a warp) reads one row, a
//     lane NPL vectors of it; the lane keeps the three taps of W for its
//     channels in registers for the whole tile; each lane issues U * NPL
//     loads before it uses any (four or more in flight);
//   - each row's three partial sums p_k are reduced over the group with
//     warp shuffles and written to shared memory; then each thread forms
//     its output rows (two at most), p_0[l-1] + p_1[l] + p_2[l+1], the x_t
//     taps and the bias.
// A scalar variant (VEC 1) takes C that is not a multiple of the vector
// width, or an h that is not 16-byte aligned.  The kernels are named
// unet_head_bf16 and unet_head_f32 by the compute dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
// output rows a CTA: with its halo a CTA reads 512 rows of h.  A round of
// loads is (THREADS / G) x U rows, a power of two of at most 512 wherever
// a row takes two lanes or more, so 512 rows are whole rounds and none runs
// nearly empty; the halo re-reads 2 / 510 of h.  Device time at the cells'
// heads (H100 80GB HBM3): 510 rows 74% and 77% of the bound, 254 rows 72%
// and 74%, 256 rows (a nearly empty last round) 65% and 64%.
constexpr int TILE = 510;
constexpr int OUT_PER_THREAD = (TILE + THREADS - 1) / THREADS;
constexpr int LOADS = 4;  // loads a lane keeps in flight (8: slower)

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// v rounded to T (round to nearest even, as torch's cast), as a float
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same_v<T, float>)
    return v;
  else
    return __bfloat162float(__float2bfloat16(v));
}

// VEC elements of T as loaded: one 16-byte vector, or one element
template <typename T, int VEC>
using Raw = std::conditional_t<VEC == 1, T, uint4>;

template <typename T, int VEC>
__device__ __forceinline__ Raw<T, VEC> load_raw(const T* p) {
  if constexpr (VEC == 1)
    return *p;
  else
    return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T, int VEC>
__device__ __forceinline__ Raw<T, VEC> zero_raw() {
  if constexpr (VEC == 1) {
    if constexpr (std::is_same_v<T, float>)
      return 0.f;
    else
      return __float2bfloat16(0.f);
  } else {
    return make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const Raw<T, VEC>& r, float* f) {
  if constexpr (VEC == 1) {
    f[0] = to_float(r);
  } else if constexpr (std::is_same_v<T, float>) {
    const float4 v = *reinterpret_cast<const float4*>(&r);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  } else {
    const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(q[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
}

// One CTA: sample blockIdx.y, output rows [blockIdx.x TILE, + TILE).
// VEC elements a load, NPL loads a lane and row, G lanes a row.
template <typename T, int VEC, int NPL>
__device__ __forceinline__ void head_tile(const T* __restrict__ h,
                                          const T* __restrict__ x,
                                          const float* __restrict__ W,
                                          const float* __restrict__ bias,
                                          float* __restrict__ out, int Lh,
                                          int C, int L0, int Cin, int G) {
  constexpr int U = NPL >= LOADS ? 1 : LOADS / NPL;   // rows a lane loads
  constexpr int ROWS = TILE + 2;
  __shared__ float part[3][ROWS];
  const int b = blockIdx.y;
  const int l0 = blockIdx.x * TILE;
  const int nvec = C / VEC;
  const int gl = threadIdx.x & (G - 1);
  const int slot = threadIdx.x / G;
  const int slots = THREADS / G;
  const int valid = Lh < L0 ? Lh : L0;   // h's rows that count: fix_len

  // x_t's taps of this thread's output rows, loaded before h's rows so
  // that their latency hides behind the loop
  const T* xb = x + static_cast<size_t>(b) * L0 * Cin;
  float xt[OUT_PER_THREAD][3];
#pragma unroll
  for (int o = 0; o < OUT_PER_THREAD; ++o)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int t = o * THREADS + threadIdx.x;
      const int r = l0 + t + k - 1;
      xt[o][k] = t < TILE && r >= 0 && r < L0
                     ? to_float(xb[static_cast<size_t>(r) * Cin])
                     : 0.f;
    }

  float w[NPL][3][VEC];
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int v = gl + i * G;
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        w[i][k][e] = v < nvec ? round_to<T>(W[k * (C + 1) + v * VEC + e])
                              : 0.f;
  }

  const T* hb = h + static_cast<size_t>(b) * Lh * C;
  // the loop's trip count is the same for every lane, so the shuffles
  // below see the whole warp; row j of the tile is h's row l0 - 1 + j
  for (int base = 0; base < ROWS; base += slots * U) {
    Raw<T, VEC> raw[U][NPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * slots + slot;
      const int r = l0 - 1 + j;
      const bool row_ok = j < ROWS && r >= 0 && r < valid;
      const T* hr = hb + static_cast<size_t>(row_ok ? r : 0) * C;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int v = gl + i * G;
        raw[u][i] = row_ok && v < nvec ? load_raw<T, VEC>(hr + v * VEC)
                                       : zero_raw<T, VEC>();
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float p0 = 0.f, p1 = 0.f, p2 = 0.f;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        float f[VEC];
        unpack<T, VEC>(raw[u][i], f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          p0 = fmaf(w[i][0][e], f[e], p0);
          p1 = fmaf(w[i][1][e], f[e], p1);
          p2 = fmaf(w[i][2][e], f[e], p2);
        }
      }
      for (int off = G >> 1; off > 0; off >>= 1) {
        p0 += __shfl_xor_sync(0xffffffffu, p0, off);
        p1 += __shfl_xor_sync(0xffffffffu, p1, off);
        p2 += __shfl_xor_sync(0xffffffffu, p2, off);
      }
      const int j = base + u * slots + slot;
      if (gl == 0 && j < ROWS) {
        part[0][j] = p0;
        part[1][j] = p1;
        part[2][j] = p2;
      }
    }
  }
  __syncthreads();

  float wx[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) wx[k] = round_to<T>(W[k * (C + 1) + C]);
#pragma unroll
  for (int o = 0; o < OUT_PER_THREAD; ++o) {
    const int t = o * THREADS + threadIdx.x;
    const int l = l0 + t;
    if (t >= TILE || l >= L0) break;
    float acc = part[0][t] + part[1][t + 1] + part[2][t + 2];
#pragma unroll
    for (int k = 0; k < 3; ++k) acc = fmaf(wx[k], xt[o][k], acc);
    out[static_cast<size_t>(b) * L0 + l] = round_to<T>(acc + bias[0]);
  }
}

template <int VEC, int NPL>
__global__ void __launch_bounds__(THREADS)
    unet_head_bf16(const __nv_bfloat16* __restrict__ h,
                   const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ W, const float* __restrict__ bias,
                   float* __restrict__ out, int Lh, int C, int L0, int Cin,
                   int G) {
  head_tile<__nv_bfloat16, VEC, NPL>(h, x, W, bias, out, Lh, C, L0, Cin, G);
}

template <int VEC, int NPL>
__global__ void __launch_bounds__(THREADS)
    unet_head_f32(const float* __restrict__ h, const float* __restrict__ x,
                  const float* __restrict__ W, const float* __restrict__ bias,
                  float* __restrict__ out, int Lh, int C, int L0, int Cin,
                  int G) {
  head_tile<float, VEC, NPL>(h, x, W, bias, out, Lh, C, L0, Cin, G);
}

template <typename T, int VEC, int NPL>
void launch_one(const T* h, const T* x, const float* W, const float* bias,
                float* out, int B, int Lh, int C, int L0, int Cin, int G,
                cudaStream_t st) {
  const dim3 grid((L0 + TILE - 1) / TILE, B);
  if constexpr (std::is_same_v<T, float>)
    unet_head_f32<VEC, NPL><<<grid, THREADS, 0, st>>>(h, x, W, bias, out, Lh,
                                                      C, L0, Cin, G);
  else
    unet_head_bf16<VEC, NPL><<<grid, THREADS, 0, st>>>(h, x, W, bias, out,
                                                       Lh, C, L0, Cin, G);
}

// The lanes a row (the smallest power of two that covers its loads, at
// most a warp) and the loads a lane (NPL: 1, 2, 4 or 8).
template <typename T, int VEC>
int launch(const void* h, const void* x, const float* W, const float* bias,
           float* out, int B, int Lh, int C, int L0, int Cin,
           cudaStream_t st) {
  const int nvec = C / VEC;
  int G = 1;
  while (G < nvec && G < 32) G <<= 1;
  const int npl = (nvec + G - 1) / G;
  const T* hp = static_cast<const T*>(h);
  const T* xp = static_cast<const T*>(x);
  if (npl <= 1)
    launch_one<T, VEC, 1>(hp, xp, W, bias, out, B, Lh, C, L0, Cin, G, st);
  else if (npl <= 2)
    launch_one<T, VEC, 2>(hp, xp, W, bias, out, B, Lh, C, L0, Cin, G, st);
  else if (npl <= 4)
    launch_one<T, VEC, 4>(hp, xp, W, bias, out, B, Lh, C, L0, Cin, G, st);
  else if (npl <= 8)
    launch_one<T, VEC, 8>(hp, xp, W, bias, out, B, Lh, C, L0, Cin, G, st);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The widest C each variant takes: 32 lanes x 8 loads of VEC elements.
int unet_head_max_channels(int bf16, int vec) {
  return 32 * 8 * (vec ? (bf16 ? 8 : 4) : 1);
}

const char* unet_head_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// h (B, Lh, C) and x (B, L0, Cin), contiguous, both f32 (bf16 = 0) or both
// bf16 (bf16 = 1); W (3, C + 1) and bias (1,) f32; out (B, L0) f32.  vec =
// 1 reads h in 16-byte vectors (C a multiple of 16 bytes' elements, h
// 16-byte aligned), vec = 0 an element at a time.  Launches on `stream`,
// does not synchronise, returns the launch error (0 on success).
int unet_head_forward(const void* h, const void* x, const float* W,
                      const float* bias, float* out, int B, int Lh, int C,
                      int L0, int Cin, int bf16, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return vec ? launch<__nv_bfloat16, 8>(h, x, W, bias, out, B, Lh, C, L0,
                                          Cin, st)
               : launch<__nv_bfloat16, 1>(h, x, W, bias, out, B, Lh, C, L0,
                                          Cin, st);
  return vec ? launch<float, 4>(h, x, W, bias, out, B, Lh, C, L0, Cin, st)
             : launch<float, 1>(h, x, W, bias, out, B, Lh, C, L0, Cin, st);
}

}  // extern "C"
