// Rank-1 bottleneck attention core for Hopper (sm_90a):
//
//     y[e, i] = sum_j softmax_j(phi[e, i] * theta[e, j]) * g[e, j]
//
// Replaces the Pallas TPU kernel relpose_gnn_tpu/ops/att_pallas.py::_kernel
// (reached through attention_core).  It computes the same function; it does
// not copy the TPU tiling, which keeps [T, C, C] logits in VMEM.
//
// What bounds it: the E * C^2 exponentials.  The inputs and the output are
// only 4 * E * C words, so the kernel is bound by operations, and of those
// by the special-function pipe: an SM computes 16 exponentials a clock, so
// a warp's `ex2` holds the pipe of its scheduler for 8 clocks, in which
// that scheduler can issue 8 instructions.  A loop that spends more than 8
// issue slots per logit is bound by instruction issue instead, and the
// first form of this kernel spent about 18 (two broadcast shared loads, a
// rounded product, a subtraction, `expf`'s range reduction around
// `ex2.approx`, an add and an FMA, in one serial chain per thread).  The
// design brings the loop to 4 issue slots per logit plus one shared load
// per 2 * kChains logits:
//
//   * exp2 domain: p2 = phi * log2(e) once per output, so the weight is
//     2^(p2 * theta_j - m2) and needs no scaling inside the loop;
//   * the logit is one FMA, f = fma(p2, theta_j, -m2), with the analytic
//     row max m2 = max(p2 * max theta, p2 * min theta) (rounding is
//     monotone, so no second pass over j).  f can exceed 0 by half an ulp
//     of m2 where the product rounds down; the weight is then 1 + eps,
//     which is as right as 1;
//   * raw `ex2.approx.ftz.f32` (2 ulp): f <= ~0, so nothing overflows, and
//     a weight that flushes to 0 beside the row's largest weight of 1 is
//     the right answer;
//   * theta and g are interleaved in shared memory and read 16 bytes at a
//     time (two (theta, g) pairs a load, the same address in every lane: a
//     broadcast), and a thread owns kChains outputs of its row (i, i + T,
//     ...), so that every loaded pair feeds kChains independent (z, acc)
//     chains, which also hide the accumulation latency;
//   * a block holds several rows when a row needs few threads (four rows
//     of 64 threads at C = 256), so that blocks stay 256 threads wide.
//
// The [E, C, C] logits are never written anywhere, not even to shared
// memory.  A row's result depends on nothing but that row: each output is
// one thread's sequential sum over j = 0 .. C-1, whatever E, the row's
// place in its block or the number of chains; there are no atomics.
// Against the plain version the arithmetic differs by one rounding of
// phi * log2(e) (relative 2^-24 on the logit's distance to the row max),
// the exact product inside the FMA (the plain version rounds phi * theta)
// and `ex2.approx`.
//
// Inputs are float32 or bfloat16 (converted to float32 on load); the output
// is float32.  Any 1 <= C <= 1024 and any E >= 0; nothing is padded: a
// column past C is never read, an odd last column is a step of its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockThreads = 256;   // at most; a multiple of 32
constexpr int kMaxRowWarps = 8;      // a row has at most 256 threads
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kChains = 4;           // outputs (independent chains) a thread

template <typename T>
__device__ __forceinline__ float to_f32(T v);

template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void warp_max_min(float& mx, float& mn) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
  }
}

// A block holds `rows_per_block` rows of `row_threads` threads (a multiple
// of 32, so no warp straddles two rows); thread t of a row owns outputs
// t, t + row_threads, ..., kChains of them.  Dynamic shared memory: per
// row `c_pad` (theta, g) pairs (c_pad even: 16-byte rows), then the rows'
// per-warp maxima and minima.
template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
att_core_kernel(const T* __restrict__ phi, const T* __restrict__ theta,
                const T* __restrict__ g, float* __restrict__ y, int e, int c,
                int row_threads, int rows_per_block, int c_pad) {
  extern __shared__ float4 smem4[];
  float2* s_tg = reinterpret_cast<float2*>(smem4);
  float* red_max = reinterpret_cast<float*>(s_tg + rows_per_block * c_pad);
  float* red_min = red_max + rows_per_block * kMaxRowWarps;

  const int rib = threadIdx.x / row_threads;          // row in block
  const int t = threadIdx.x - rib * row_threads;      // thread in row
  const long long row =
      static_cast<long long>(blockIdx.x) * rows_per_block + rib;
  const bool row_ok = row < e;
  const long long base = row * c;
  float2* s_row = s_tg + rib * c_pad;

  float p2[kChains];
  float tmax = -INFINITY;
  float tmin = INFINITY;
#pragma unroll
  for (int r = 0; r < kChains; ++r) {
    const int i = t + r * row_threads;
    p2[r] = 0.f;
    if (row_ok && i < c) {
      const float th = to_f32(theta[base + i]);
      s_row[i] = make_float2(th, to_f32(g[base + i]));
      p2[r] = to_f32(phi[base + i]) * kLog2e;
      tmax = fmaxf(tmax, th);
      tmin = fminf(tmin, th);
    }
  }
  warp_max_min(tmax, tmin);
  if ((t & 31) == 0) {
    red_max[rib * kMaxRowWarps + (t >> 5)] = tmax;
    red_min[rib * kMaxRowWarps + (t >> 5)] = tmin;
  }
  __syncthreads();
  if (!row_ok || t >= c) return;
  for (int w = 0; w < (row_threads >> 5); ++w) {
    tmax = fmaxf(tmax, red_max[rib * kMaxRowWarps + w]);
    tmin = fminf(tmin, red_min[rib * kMaxRowWarps + w]);
  }

  // a chain past C runs on p2 = 0 (weights of 1) and is not stored
  float neg_m2[kChains];
  float z[kChains];
  float acc[kChains];
#pragma unroll
  for (int r = 0; r < kChains; ++r) {
    neg_m2[r] = -fmaxf(p2[r] * tmax, p2[r] * tmin);
    z[r] = 0.f;
    acc[r] = 0.f;
  }
  const float4* s_pairs = reinterpret_cast<const float4*>(s_row);
  const int pairs = c >> 1;
#pragma unroll 2
  for (int j = 0; j < pairs; ++j) {
    const float4 v = s_pairs[j];   // theta_2j, g_2j, theta_2j+1, g_2j+1
#pragma unroll
    for (int r = 0; r < kChains; ++r) {
      const float w0 = ex2_approx(fmaf(p2[r], v.x, neg_m2[r]));
      z[r] += w0;
      acc[r] = fmaf(w0, v.y, acc[r]);
      const float w1 = ex2_approx(fmaf(p2[r], v.z, neg_m2[r]));
      z[r] += w1;
      acc[r] = fmaf(w1, v.w, acc[r]);
    }
  }
  if (c & 1) {
    const float2 v = s_row[c - 1];
#pragma unroll
    for (int r = 0; r < kChains; ++r) {
      const float w0 = ex2_approx(fmaf(p2[r], v.x, neg_m2[r]));
      z[r] += w0;
      acc[r] = fmaf(w0, v.y, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kChains; ++r) {
    const int i = t + r * row_threads;
    if (i < c) y[base + i] = acc[r] / z[r];
  }
}

template <typename T>
void launch(const void* phi, const void* theta, const void* g, void* y,
            int e, int c, cudaStream_t s) {
  const int per_thread = (c + kChains - 1) / kChains;
  const int row_threads = (per_thread + 31) / 32 * 32;
  const int rows_per_block = kBlockThreads / row_threads;
  const int c_pad = (c + 1) & ~1;
  const dim3 grid((e + rows_per_block - 1) / rows_per_block);
  const dim3 block(rows_per_block * row_threads);
  const size_t smem =
      static_cast<size_t>(rows_per_block) *
      (c_pad * sizeof(float2) + 2 * kMaxRowWarps * sizeof(float));
  att_core_kernel<T><<<grid, block, smem, s>>>(
      static_cast<const T*>(phi), static_cast<const T*>(theta),
      static_cast<const T*>(g), static_cast<float*>(y), e, c, row_threads,
      rows_per_block, c_pad);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 inputs, 1 = bfloat16 inputs.  Launches on `stream`,
// does not synchronise, allocates nothing.  Returns cudaGetLastError().
int att_core_forward(const void* phi, const void* theta, const void* g,
                     void* y, int e, int c, int dtype, void* stream) {
  if (e < 0 || c < 1 || c > 1024) return cudaErrorInvalidValue;
  if (e == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(phi, theta, g, y, e, c, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(phi, theta, g, y, e, c, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* att_core_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
