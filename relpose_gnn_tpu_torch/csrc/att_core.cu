// Rank-1 bottleneck attention core for Hopper (sm_90a):
//
//     y[e, i] = sum_j softmax_j(phi[e, i] * theta[e, j]) * g[e, j]
//
// Replaces the Pallas TPU kernel relpose_gnn_tpu/ops/att_pallas.py::_kernel
// (reached through attention_core).  It computes the same function; it does
// not copy the TPU tiling, which keeps [T, C, C] logits in VMEM.
//
// What bounds it: the E * C^2 expf calls.  The inputs and the output are
// only 4 * E * C words, so the kernel is bound by operations (the SFU exp
// pipe and the FMA pipe), not by bytes.  The design therefore never writes
// the [E, C, C] logits anywhere, not even to shared memory: one block owns
// one row e, stages theta[e] and g[e] in shared memory (every thread of a
// warp reads the same element, a broadcast), and each thread keeps its own
// row of logits in registers, one at a time.
//
// The row max is analytic: max_j fl(phi_i * theta_j) is fl(phi_i * max theta)
// when phi_i >= 0 and fl(phi_i * min theta) otherwise, because rounding is
// monotone.  It is therefore bit-exact with the plain max, and each thread
// makes a single pass over j (exp, row sum, weighted sum).  __fmul_rn keeps
// the compiler from contracting the product into an FMA, so the logits
// are the rounded products the plain version computes.  expf (not __expf)
// keeps the result within 1e-5 of the plain version.
//
// Inputs are float32 or bfloat16 (converted to float32 on load); the output
// is float32.  Any 1 <= C <= 1024 and any E >= 0; no padding is needed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T v);

template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void warp_max_min(float& mx, float& mn) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
  }
}

// One block per row; blockDim.x = C rounded up to a multiple of 32.
// Dynamic shared memory: theta[C] then g[C], as float32.
template <typename T>
__global__ void att_core_kernel(const T* __restrict__ phi,
                                const T* __restrict__ theta,
                                const T* __restrict__ g,
                                float* __restrict__ y, int c) {
  extern __shared__ float smem[];
  __shared__ float red_max[32];
  __shared__ float red_min[32];
  float* s_theta = smem;
  float* s_g = smem + c;

  const long long base = static_cast<long long>(blockIdx.x) * c;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const int n_warps = blockDim.x >> 5;

  float p = 0.f;
  float tmax = -INFINITY;
  float tmin = INFINITY;
  if (i < c) {
    const float t = to_f32(theta[base + i]);
    s_theta[i] = t;
    s_g[i] = to_f32(g[base + i]);
    p = to_f32(phi[base + i]);
    tmax = t;
    tmin = t;
  }
  warp_max_min(tmax, tmin);
  if (lane == 0) {
    red_max[warp] = tmax;
    red_min[warp] = tmin;
  }
  __syncthreads();
  if (warp == 0) {
    tmax = lane < n_warps ? red_max[lane] : -INFINITY;
    tmin = lane < n_warps ? red_min[lane] : INFINITY;
    warp_max_min(tmax, tmin);
    if (lane == 0) {
      red_max[0] = tmax;
      red_min[0] = tmin;
    }
  }
  __syncthreads();
  if (i >= c) return;
  tmax = red_max[0];
  tmin = red_min[0];

  const float m = fmaxf(__fmul_rn(p, tmax), __fmul_rn(p, tmin));
  float z = 0.f;
  float acc = 0.f;
  for (int j = 0; j < c; ++j) {
    const float w = expf(__fmul_rn(p, s_theta[j]) - m);
    z += w;
    acc = fmaf(w, s_g[j], acc);
  }
  y[base + i] = acc / z;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 inputs, 1 = bfloat16 inputs.  Launches on `stream`,
// does not synchronise, allocates nothing.  Returns cudaGetLastError().
int att_core_forward(const void* phi, const void* theta, const void* g,
                     void* y, int e, int c, int dtype, void* stream) {
  if (e < 0 || c < 1 || c > 1024) return cudaErrorInvalidValue;
  if (e == 0) return cudaSuccess;
  const dim3 grid(e);
  const dim3 block((c + 31) / 32 * 32);
  const size_t smem = 2 * static_cast<size_t>(c) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    att_core_kernel<float><<<grid, block, smem, s>>>(
        static_cast<const float*>(phi), static_cast<const float*>(theta),
        static_cast<const float*>(g), static_cast<float*>(y), c);
  } else if (dtype == 1) {
    att_core_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(
        static_cast<const __nv_bfloat16*>(phi),
        static_cast<const __nv_bfloat16*>(theta),
        static_cast<const __nv_bfloat16*>(g), static_cast<float*>(y), c);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* att_core_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
