// Restructured forms of the rank-1 bottleneck attention core for Hopper
// (sm_90a).  Every form computes the function of csrc/att_core.cu,
//
//     y[e, i] = sum_j softmax_j(phi[e, i] * theta[e, j]) * g[e, j]
//
// and differs only in how.  They replace the Pallas TPU kernel bodies of
// three probe benches, and exist for the same reason those did: to find
// out which restructuring of the production kernel pays on this hardware.
//
//   form        replaces (TPU kernel body)                      what differs
//   scanned     relpose_gnn_tpu/ops/att_pallas.py::_kernel, as   row max by a first pass over j
//               bench_att_variants2.py's `base`
//   analytic    bench_att_variants2.py::_kernel_v1               row max from max/min theta, one pass
//   chunked     bench_att_variants2.py::_kernel_v2               analytic max; (z, y) partial sums per
//                                                                chunk of 128 columns, added in order
//   exp2        bench_att_variants.py::_kernel_exp2 and          phi scaled by log2(e) once per
//               bench_att_exp2.py::_kernel_exp2 (one body)       thread; exp2f per logit
//   mma         bench_att_variants.py::_kernel_mxu               the two sums over j as the product
//   mma_exp2    the same with use_exp2                           w[C, C] @ [g | 1] on the tensor cores
//
// They are not carried over block by block: no [T, C, C] logits anywhere.
// All forms share att_core.cu's row layout: one block owns one row e and
// stages theta[e] and g[e] in shared memory as float32.
//
// What bounds them: as att_core.cu, the E * C^2 exponentials (operations,
// not bytes).  What each form does about it is its name; which of them
// helps is what benchmarks/bench_att_variants*.py measure.
//
// Scalar forms (scanned, analytic, chunked, exp2): thread i owns output i
// and keeps its logits in registers, one at a time.  Every logit is the
// rounded product __fmul_rn(p, theta_j), never contracted into an FMA, and
// every form but exp2 calls the same expf, so `analytic` equals `scanned`
// bit for bit: the analytic max max(fl(p * max theta), fl(p * min theta))
// is one of the scanned products and rounding is monotone.  `chunked`
// keeps two chunks' accumulators live at once, which breaks the serial
// z += w; y = fma(w, g, y) chain of the single-pass loop; it differs from
// `analytic` by summation order only.  `exp2` takes the analytic max of the
// scaled products; the scaled max is the max of the scaled products since
// log2(e) > 0.
//
// Tensor-core forms (mma, mma_exp2): a warp owns a strip of 16 outputs i
// and issues mma.sync.m16n8k8 (TF32 operands, float32 accumulators) over j
// in steps of 8.  The logits are rank-1, so each thread computes the four
// w[i, j] of its A fragment straight into registers from phi_i and
// theta_j; w never passes through shared memory.  B is [g | 1] padded to
// n = 8 columns: column 0 gives y, column 1 gives z, six columns are zero.
// Hopper has no float32 mma, and one TF32 product would round w and g to
// 10 mantissa bits (about 1e-3).  To keep the TPU body's float32 sums the
// operands are split, w = w_hi + w_lo and g = g_hi + g_lo with each part
// exact in TF32 (by truncation, see split_tf32), and three products are
// accumulated (w_lo g_hi and w_hi g_lo into one accumulator, w_hi g_hi
// into another, added at the end); what is dropped, w_lo g_lo and the
// tails of the low parts, is about 2^-20 relative, and the part of it
// that comes from w is the same in y's numerator and in z.  The ones
// column is exact in TF32.
//
// Inputs are float32 or bfloat16 (converted to float32 on load); the output
// is float32.  Any 1 <= C <= 1024 and any E >= 0; no padding of E.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kChunk = 128;

enum Form {
  kScanned = 0,
  kAnalytic = 1,
  kChunked = 2,
  kExp2 = 3,
  kMma = 4,
  kMmaExp2 = 5
};

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

// Stages theta[e] and g[e] (and phi[e] where s_phi is not null) as float32
// in shared memory, zero-filled from c up to `padded`, and hands every
// thread the row's max and min theta.  Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ void stage_row(
    const T* __restrict__ phi, const T* __restrict__ theta,
    const T* __restrict__ g, long long base, int c, int padded,
    float* s_theta, float* s_g, float* s_phi, float& tmax, float& tmin) {
  __shared__ float red_max[32];
  __shared__ float red_min[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  tmax = -INFINITY;
  tmin = INFINITY;
  for (int k = threadIdx.x; k < padded; k += blockDim.x) {
    float t = 0.f, gv = 0.f, pv = 0.f;
    if (k < c) {
      t = to_f32(theta[base + k]);
      gv = to_f32(g[base + k]);
      if (s_phi != nullptr) pv = to_f32(phi[base + k]);
      tmax = fmaxf(tmax, t);
      tmin = fminf(tmin, t);
    }
    s_theta[k] = t;
    s_g[k] = gv;
    if (s_phi != nullptr) s_phi[k] = pv;
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
  tmax = red_max[0];
  tmin = red_min[0];
}

// exp(p * t - m), or exp2 of the same with p and m already scaled.
template <bool EXP2>
__device__ __forceinline__ float weight(float p, float t, float m) {
  const float f = __fmul_rn(p, t) - m;
  return EXP2 ? exp2f(f) : expf(f);
}

// Scalar forms.  One block per row; blockDim.x = C rounded up to a multiple
// of 32.  Dynamic shared memory: theta[C] then g[C], as float32.
template <typename T, int FORM>
__global__ void att_variant_kernel(const T* __restrict__ phi,
                                   const T* __restrict__ theta,
                                   const T* __restrict__ g,
                                   float* __restrict__ y, int c) {
  extern __shared__ float smem[];
  float* s_theta = smem;
  float* s_g = smem + c;
  const long long base = static_cast<long long>(blockIdx.x) * c;
  const int i = threadIdx.x;
  constexpr bool kUseExp2 = FORM == kExp2;

  float tmax, tmin;
  stage_row<T>(phi, theta, g, base, c, c, s_theta, s_g, nullptr, tmax, tmin);
  if (i >= c) return;
  float p = to_f32(phi[base + i]);
  if (kUseExp2) p = __fmul_rn(p, kLog2e);

  float m;
  if (FORM == kScanned) {
    m = -INFINITY;
    for (int j = 0; j < c; ++j) m = fmaxf(m, __fmul_rn(p, s_theta[j]));
  } else {
    m = fmaxf(__fmul_rn(p, tmax), __fmul_rn(p, tmin));
  }

  float z = 0.f;
  float acc = 0.f;
  if (FORM == kChunked) {
    // two chunks of 128 columns at a time, each with its own (z, y); the
    // partial sums join the totals in chunk order
    for (int k0 = 0; k0 < c; k0 += 2 * kChunk) {
      const int len0 = min(kChunk, c - k0);
      const int len1 = max(0, min(kChunk, c - k0 - kChunk));
      const float* th0 = s_theta + k0;
      const float* th1 = th0 + kChunk;
      const float* g0 = s_g + k0;
      const float* g1 = g0 + kChunk;
      float z0 = 0.f, y0 = 0.f, z1 = 0.f, y1 = 0.f;
      int j = 0;
      for (; j < len1; ++j) {
        const float w0 = weight<false>(p, th0[j], m);
        const float w1 = weight<false>(p, th1[j], m);
        z0 += w0;
        y0 = fmaf(w0, g0[j], y0);
        z1 += w1;
        y1 = fmaf(w1, g1[j], y1);
      }
      for (; j < len0; ++j) {
        const float w0 = weight<false>(p, th0[j], m);
        z0 += w0;
        y0 = fmaf(w0, g0[j], y0);
      }
      z += z0;
      acc += y0;
      z += z1;
      acc += y1;
    }
  } else {
    for (int j = 0; j < c; ++j) {
      const float w = weight<kUseExp2>(p, s_theta[j], m);
      z += w;
      acc = fmaf(w, s_g[j], acc);
    }
  }
  y[base + i] = acc / z;
}

// v = hi + lo + (at most 2^-20 |v|), hi and lo exact in TF32.  The split
// truncates (a mask on the ALU pipe) instead of rounding with
// cvt.rna.tf32.f32: conversions share the special-function pipe with the
// exponential, and two of them per logit made that pipe, not the FMA pipe,
// the limit (the first version of these forms ran at half this speed).
constexpr uint32_t kTf32Mask = 0xffffe000u;

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(v) & kTf32Mask;
  lo = __float_as_uint(v - __uint_as_float(hi)) & kTf32Mask;
}

// d += a[16 x 8] * b[8 x 8], TF32 operands, float32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Tensor-core forms.  One block per row, up to 8 warps; warp w takes the
// 16-output strips w, w + n_warps, ...  Dynamic shared memory: theta, the
// TF32 halves g_hi and g_lo (split once per row, not per step) and phi,
// each C rounded up to a multiple of 16, as float32.
//
// Fragment layout of m16n8k8 (gid = lane / 4, tig = lane % 4):
//   A: a0 (row gid, k tig)  a1 (row gid + 8, k tig)
//      a2 (row gid, k tig + 4)  a3 (row gid + 8, k tig + 4)
//   B: b0 (k tig, col gid)  b1 (k tig + 4, col gid)
//   D: d0 (row gid, col 2 tig)  d1 (row gid, col 2 tig + 1)
//      d2, d3 the same for row gid + 8
// so the threads with tig == 0 end up holding y (col 0) and z (col 1).
template <typename T, bool EXP2>
__global__ void att_variant_mma_kernel(const T* __restrict__ phi,
                                       const T* __restrict__ theta,
                                       const T* __restrict__ g,
                                       float* __restrict__ y, int c) {
  extern __shared__ float smem[];
  const int padded = (c + 15) / 16 * 16;
  float* s_theta = smem;
  float* s_g_hi = smem + padded;
  float* s_phi = smem + 2 * padded;
  float* s_g_lo = smem + 3 * padded;
  const long long base = static_cast<long long>(blockIdx.x) * c;

  float tmax, tmin;
  stage_row<T>(phi, theta, g, base, c, padded, s_theta, s_g_hi, s_phi, tmax,
               tmin);
  for (int k = threadIdx.x; k < padded; k += blockDim.x) {
    uint32_t hi, lo;
    split_tf32(s_g_hi[k], hi, lo);
    s_g_hi[k] = __uint_as_float(hi);
    s_g_lo[k] = __uint_as_float(lo);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const uint32_t one = __float_as_uint(1.0f);

  for (int strip = warp; strip < padded / 16; strip += n_warps) {
    const int r0 = strip * 16 + gid;
    const int r1 = r0 + 8;
    // rows at or beyond c hold phi = 0: finite weights, never written
    float p0 = s_phi[r0];
    float p1 = s_phi[r1];
    if (EXP2) {
      p0 = __fmul_rn(p0, kLog2e);
      p1 = __fmul_rn(p1, kLog2e);
    }
    const float m0 = fmaxf(__fmul_rn(p0, tmax), __fmul_rn(p0, tmin));
    const float m1 = fmaxf(__fmul_rn(p1, tmax), __fmul_rn(p1, tmin));
    float big[4] = {0.f, 0.f, 0.f, 0.f};
    float small[4] = {0.f, 0.f, 0.f, 0.f};

    for (int j0 = 0; j0 < c; j0 += 8) {
      const int ja = j0 + tig;
      const int jb = ja + 4;
      const float ta = s_theta[ja];
      const float tb = s_theta[jb];
      float w[4];
      w[0] = weight<EXP2>(p0, ta, m0);
      w[1] = weight<EXP2>(p1, ta, m1);
      w[2] = weight<EXP2>(p0, tb, m0);
      w[3] = weight<EXP2>(p1, tb, m1);
      if (j0 + 8 > c) {
        // columns at or beyond c carry no weight (their theta is the
        // zero fill, whose weight need not even be finite)
        if (ja >= c) w[0] = w[1] = 0.f;
        if (jb >= c) w[2] = w[3] = 0.f;
      }
      uint32_t a_hi[4], a_lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) split_tf32(w[q], a_hi[q], a_lo[q]);

      // B = [g | 1 | 0 ...]: this thread holds column gid at k = tig, tig+4
      uint32_t b_hi0 = 0u, b_hi1 = 0u, b_lo0 = 0u, b_lo1 = 0u;
      if (gid == 0) {
        b_hi0 = __float_as_uint(s_g_hi[ja]);
        b_lo0 = __float_as_uint(s_g_lo[ja]);
        b_hi1 = __float_as_uint(s_g_hi[jb]);
        b_lo1 = __float_as_uint(s_g_lo[jb]);
      } else if (gid == 1) {
        b_hi0 = one;
        b_hi1 = one;
      }
      mma_tf32(small, a_lo, b_hi0, b_hi1);
      mma_tf32(small, a_hi, b_lo0, b_lo1);
      mma_tf32(big, a_hi, b_hi0, b_hi1);
    }
    if (tig == 0) {
      if (r0 < c) y[base + r0] = (big[0] + small[0]) / (big[1] + small[1]);
      if (r1 < c) y[base + r1] = (big[2] + small[2]) / (big[3] + small[3]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* phi, const void* theta, const void* g, void* y,
                   int e, int c, int form, cudaStream_t s) {
  const T* p = static_cast<const T*>(phi);
  const T* t = static_cast<const T*>(theta);
  const T* gg = static_cast<const T*>(g);
  float* out = static_cast<float*>(y);
  const dim3 grid(e);
  if (form == kMma || form == kMmaExp2) {
    const int padded = (c + 15) / 16 * 16;
    const int strips = padded / 16;
    const dim3 block(32 * (strips < 8 ? strips : 8));
    const size_t smem = 4 * static_cast<size_t>(padded) * sizeof(float);
    if (form == kMma) {
      att_variant_mma_kernel<T, false><<<grid, block, smem, s>>>(p, t, gg, out,
                                                                 c);
    } else {
      att_variant_mma_kernel<T, true><<<grid, block, smem, s>>>(p, t, gg, out,
                                                                c);
    }
    return cudaGetLastError();
  }
  const dim3 block((c + 31) / 32 * 32);
  const size_t smem = 2 * static_cast<size_t>(c) * sizeof(float);
  switch (form) {
    case kScanned:
      att_variant_kernel<T, kScanned><<<grid, block, smem, s>>>(p, t, gg, out,
                                                                c);
      break;
    case kAnalytic:
      att_variant_kernel<T, kAnalytic><<<grid, block, smem, s>>>(p, t, gg, out,
                                                                 c);
      break;
    case kChunked:
      att_variant_kernel<T, kChunked><<<grid, block, smem, s>>>(p, t, gg, out,
                                                                c);
      break;
    case kExp2:
      att_variant_kernel<T, kExp2><<<grid, block, smem, s>>>(p, t, gg, out, c);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 inputs, 1 = bfloat16 inputs.  form: the Form enum
// above.  Launches on `stream`, does not synchronise, allocates nothing.
// Returns cudaGetLastError().
int att_variants_forward(const void* phi, const void* theta, const void* g,
                         void* y, int e, int c, int dtype, int form,
                         void* stream) {
  if (e < 0 || c < 1 || c > 1024) return cudaErrorInvalidValue;
  if (form < kScanned || form > kMmaExp2) return cudaErrorInvalidValue;
  if (e == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(launch<float>(phi, theta, g, y, e, c, form, s));
  }
  if (dtype == 1) {
    return static_cast<int>(
        launch<__nv_bfloat16>(phi, theta, g, y, e, c, form, s));
  }
  return cudaErrorInvalidValue;
}

const char* att_variants_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
