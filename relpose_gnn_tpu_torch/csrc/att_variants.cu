// Restructured forms of the rank-1 bottleneck attention core for Hopper
// (sm_90a).  Every form computes the function of csrc/att_core.cu,
//
//     y[e, i] = sum_j softmax_j(phi[e, i] * theta[e, j]) * g[e, j]
//
// and differs only in how.  They replace the Pallas TPU kernel bodies of
// three probe benches, and exist for the same reason those did: to find
// out which restructuring of the attention kernel pays on this hardware.
//
//   form        replaces (TPU kernel body)                      what makes it that form
//   scanned     relpose_gnn_tpu/ops/att_pallas.py::_kernel, as   row max by a first pass over j
//               bench_att_variants2.py's `base`
//   analytic    bench_att_variants2.py::_kernel_v1               row max from max/min theta, one pass
//   chunked     bench_att_variants2.py::_kernel_v2               analytic max; (z, y) partial sums per
//                                                                chunk of 128 columns, added in order
//   exp2        bench_att_variants.py::_kernel_exp2 and          phi scaled by log2(e) once per
//               bench_att_exp2.py::_kernel_exp2 (one body)       output; 2^x per logit
//   mma         bench_att_variants.py::_kernel_mxu               the two sums over j as the product
//   mma_exp2    the same with use_exp2                           w[C, C] @ [g | 1] on the tensor cores,
//                                                                float32-accurate (Precision.HIGHEST)
//
// No [T, C, C] logits anywhere, not even in shared memory.  Inputs are
// float32 or bfloat16 (converted to float32 on load); the output is
// float32.  Any 1 <= C <= 1024 and any E >= 0; no padding of E.
//
// What bounds every form: as att_core.cu, the E * C^2 exponentials
// (operations, not bytes).  An SM computes 16 exponentials a clock, so a
// warp's exponential holds the special-function pipe of its scheduler for
// 8 clocks, in which the scheduler can issue 8 instructions: a loop that
// spends more than 8 issue slots per logit is bound by issue instead.
//
// Two routes, chosen by the caller (`route`):
//
// Route "simple": the first kernels of these forms, kept as they were to
// time the default route against (att_variant_kernel,
// att_variant_mma_kernel).  One block per row.  Scalar forms: thread i owns
// output i; every logit is the rounded product __fmul_rn(p, theta_j) minus
// the max, then expf (exp2f for exp2), in one serial z += w; acc =
// fma(w, g, acc) chain a thread, theta_j and g_j as two 4-byte shared loads:
// 12-15 issue slots per logit, issue-bound (`scanned` adds a whole pass of
// loads, products and compares).  Tensor-core forms: a warp owns a strip of
// 16 outputs and issues mma.sync.m16n8k8 (TF32) over j in steps of 8, with
// B = [g | 1] padded to 8 columns; w and g are split into TF32 halves and
// three products (w_lo g_hi, w_hi g_lo, w_hi g_hi) are accumulated, and each
// weight costs the rounded product, a subtraction, a full expf/exp2f and
// the split: about 15 issue slots per logit.
//
// Default route: the lessons of att_core.cu's design, keeping what makes
// each form that form.
//
//   Scalar forms (variant_chains_kernel: scanned, analytic, chunked).
//   * A thread owns kChains outputs of its row (i, i + T, ...), so every
//     shared load feeds kChains independent chains, which also hide the
//     accumulation latency; a block holds several rows when a row needs few
//     threads (four rows of 64 threads at C = 256).
//   * theta and g are interleaved in shared memory and read 16 bytes at a
//     time, two (theta, g) pairs a load, the same address in every lane of
//     the row (a broadcast).
//   * The logit is one FMA against the negated max, f = fma(p, theta_j,
//     -m), then one multiply by log2(e) (these forms are not the exp2 form:
//     they pay that scale on every logit) and a raw ex2.approx.ftz.f32:
//     5 issue slots per logit with z and acc, plus a load per 8 logits.
//   * `scanned` keeps its first pass over j, the max of the rounded
//     products __fmul_rn(p, theta_j), over the same packed loads and
//     chains (2 slots per logit more, and no exponential: the warps in
//     that pass issue while the others hold the special-function pipe).
//     That max equals `analytic`'s max(fl(p * max theta), fl(p * min
//     theta)), one of the row's rounded products (rounding is monotone);
//     the exponential pass is the same code with the arithmetic pinned by
//     intrinsics (fmaf, __fmul_rn, __fadd_rn), so `analytic` equals
//     `scanned` bit for bit.
//   * `chunked` keeps a (z, y) pair per chunk of 128 columns per chain;
//     each chunk's pair joins the totals in chunk order.
//
//   Tensor-core forms (variant_tc_kernel: mma, mma_exp2).
//   * The weight is one FMA and a raw ex2.approx (plus the log2(e)
//     multiply in `mma`; `mma_exp2` scales phi once per output).
//   * B holds g_hi, g_lo and a column of ones in its columns 0, 1, 2
//     (columns 3-7 zero), so two mma.sync a 16x8 tile, one with w_hi and
//     one with w_lo, give every product w * g and both parts of z: w_hi g_hi
//     + w_hi g_lo + w_lo g_hi + w_lo g_lo in columns 0 + 1, z in column 2.
//     The first kernel spent three.  g is split once per row while it is
//     staged; w costs a mask, a subtraction and a mask.  What is dropped is
//     the truncated tails of w_lo and g_lo, about 2^-20 relative, the part
//     from w alike in y's numerator and in z.
//   * A warp carries kStrips strips of 16 outputs (64 rows) at once over
//     j, so a step's theta pair and B pair, one 8-byte shared load each,
//     feed 16 weights a thread and 8 mma.sync; the k index of a step is
//     laid out so that a thread's two columns j, j + 1 are adjacent.
//     Several rows share a block; a warp's first phi values are loaded
//     while the row is staged, and the loop over j is unrolled two steps.
//   * Per logit: 5 (mma_exp2) or 6 (mma) issue slots beside the mma and
//     the loads.  The tensor cores are not the bound: 2 m16n8k8 products
//     per 128 logits are 32 flop a logit.  These two forms reach about
//     2/3 of their bound, the scalar forms 3/4 to 6/7 (PERF.md).
//
// The exp2 form has one kernel on both routes: its first form already
// reads 0.6 of its bound.
//
// Against the plain versions the default route differs by the exact
// product inside the FMA (the plain versions round phi * theta), the
// rounding of f * log2(e) (or of phi * log2(e)), ex2.approx (2 ulp) and
// the order of the sums; a few 1e-6 of max |y| at unit scale.

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

enum Route { kDefault = 0, kSimple = 1 };

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

// ===========================================================================
// Route "simple": the first kernels, unchanged
// ===========================================================================

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
// of 32.  Dynamic shared memory: theta[C] then g[C], as float32.  Also the
// exp2 form's kernel on the default route.
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
cudaError_t launch_simple(const T* p, const T* t, const T* gg, float* out,
                          int e, int c, int form, cudaStream_t s) {
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

// ===========================================================================
// Default route
// ===========================================================================

constexpr int kBlockThreads = 256;   // at most; a multiple of 32
constexpr int kMaxRowWarps = 8;      // a row has at most 256 threads
constexpr int kChains = 4;           // outputs (independent chains) a thread
constexpr int kStrips = 4;           // 16-row strips a tensor-core warp carries
constexpr int kGroupRows = 16 * kStrips;
constexpr int kTcUnroll = 2;         // steps of 8 columns unrolled together

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The row's max and min theta for every thread of the row: each warp's
// own through shuffles, then the row's warps' through shared memory.
// Every thread of the block calls it (it holds a __syncthreads()).
__device__ __forceinline__ void row_max_min(float& tmax, float& tmin,
                                            float* red_max, float* red_min,
                                            int rib, int t, int row_warps) {
  warp_max_min(tmax, tmin);
  if ((t & 31) == 0) {
    red_max[rib * kMaxRowWarps + (t >> 5)] = tmax;
    red_min[rib * kMaxRowWarps + (t >> 5)] = tmin;
  }
  __syncthreads();
  for (int w = 0; w < row_warps; ++w) {
    tmax = fmaxf(tmax, red_max[rib * kMaxRowWarps + w]);
    tmin = fminf(tmin, red_min[rib * kMaxRowWarps + w]);
  }
}

// One column j of every chain: w = 2^(fma(p, theta_j, -m) * log2(e)),
// z += w, acc += w * g_j, with the arithmetic pinned by intrinsics (no
// contraction can make one form's pass differ from another's).
__device__ __forceinline__ void exp_column(float t, float gv,
                                           const float (&p)[kChains],
                                           const float (&neg_m)[kChains],
                                           float (&z)[kChains],
                                           float (&acc)[kChains]) {
#pragma unroll
  for (int r = 0; r < kChains; ++r) {
    const float w = ex2_approx(__fmul_rn(fmaf(p[r], t, neg_m[r]), kLog2e));
    z[r] = __fadd_rn(z[r], w);
    acc[r] = fmaf(w, gv, acc[r]);
  }
}

// Columns [0, n) of packed (theta, g) pairs, in order.
__device__ __forceinline__ void exp_pass(const float2* s_tg, int n,
                                         const float (&p)[kChains],
                                         const float (&neg_m)[kChains],
                                         float (&z)[kChains],
                                         float (&acc)[kChains]) {
  const float4* s_pairs = reinterpret_cast<const float4*>(s_tg);
#pragma unroll 2
  for (int j = 0; j < (n >> 1); ++j) {
    const float4 v = s_pairs[j];   // theta_2j, g_2j, theta_2j+1, g_2j+1
    exp_column(v.x, v.y, p, neg_m, z, acc);
    exp_column(v.z, v.w, p, neg_m, z, acc);
  }
  if (n & 1) {
    const float2 v = s_tg[n - 1];
    exp_column(v.x, v.y, p, neg_m, z, acc);
  }
}

// Scalar forms (scanned, analytic, chunked).  A block holds
// `rows_per_block` rows of `row_threads` threads (a multiple of 32, so no
// warp straddles two rows); thread t of a row owns outputs t,
// t + row_threads, ..., kChains of them.  Dynamic shared memory: per row
// `c_pad` (theta, g) pairs (c_pad even: 16-byte rows), then the rows'
// per-warp maxima and minima.
template <typename T, int FORM>
__global__ void __launch_bounds__(kBlockThreads)
variant_chains_kernel(const T* __restrict__ phi, const T* __restrict__ theta,
                      const T* __restrict__ g, float* __restrict__ y, int e,
                      int c, int row_threads, int rows_per_block, int c_pad) {
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

  float p[kChains];
  float tmax = -INFINITY;
  float tmin = INFINITY;
#pragma unroll
  for (int r = 0; r < kChains; ++r) {
    const int i = t + r * row_threads;
    p[r] = 0.f;
    if (row_ok && i < c) {
      const float th = to_f32(theta[base + i]);
      s_row[i] = make_float2(th, to_f32(g[base + i]));
      p[r] = to_f32(phi[base + i]);
      tmax = fmaxf(tmax, th);
      tmin = fminf(tmin, th);
    }
  }
  row_max_min(tmax, tmin, red_max, red_min, rib, t, row_threads >> 5);
  if (!row_ok || t >= c) return;

  // a chain past C runs on p = 0 (weights of 1) and is not stored
  float neg_m[kChains];
  if (FORM == kScanned) {
    float m[kChains];
#pragma unroll
    for (int r = 0; r < kChains; ++r) m[r] = -INFINITY;
    const float4* s_pairs = reinterpret_cast<const float4*>(s_row);
#pragma unroll 2
    for (int j = 0; j < (c >> 1); ++j) {
      const float4 v = s_pairs[j];
#pragma unroll
      for (int r = 0; r < kChains; ++r) {
        m[r] = fmaxf(m[r], __fmul_rn(p[r], v.x));
        m[r] = fmaxf(m[r], __fmul_rn(p[r], v.z));
      }
    }
    if (c & 1) {
      const float th = s_row[c - 1].x;
#pragma unroll
      for (int r = 0; r < kChains; ++r) m[r] = fmaxf(m[r], __fmul_rn(p[r], th));
    }
#pragma unroll
    for (int r = 0; r < kChains; ++r) neg_m[r] = -m[r];
  } else {
#pragma unroll
    for (int r = 0; r < kChains; ++r) {
      neg_m[r] = -fmaxf(__fmul_rn(p[r], tmax), __fmul_rn(p[r], tmin));
    }
  }

  float z[kChains];
  float acc[kChains];
#pragma unroll
  for (int r = 0; r < kChains; ++r) {
    z[r] = 0.f;
    acc[r] = 0.f;
  }
  if (FORM == kChunked) {
    for (int k0 = 0; k0 < c; k0 += kChunk) {
      float zc[kChains];
      float yc[kChains];
#pragma unroll
      for (int r = 0; r < kChains; ++r) {
        zc[r] = 0.f;
        yc[r] = 0.f;
      }
      exp_pass(s_row + k0, min(kChunk, c - k0), p, neg_m, zc, yc);
#pragma unroll
      for (int r = 0; r < kChains; ++r) {
        z[r] = __fadd_rn(z[r], zc[r]);
        acc[r] = __fadd_rn(acc[r], yc[r]);
      }
    }
  } else {
    exp_pass(s_row, c, p, neg_m, z, acc);
  }
#pragma unroll
  for (int r = 0; r < kChains; ++r) {
    const int i = t + r * row_threads;
    if (i < c) y[base + i] = acc[r] / z[r];
  }
}

// One step of 8 columns j0 .. j0 + 7 for the kStrips strips of a warp.  The
// step's k index maps to j so that a thread's two columns are adjacent:
// k = tig is j = j0 + 2 tig, k = tig + 4 is j0 + 2 tig + 1 (A and B agree,
// so the product is the same).  TAIL: columns at or beyond c carry no
// weight (their theta is the zero fill, whose weight need not be finite).
template <bool EXP2, bool TAIL>
__device__ __forceinline__ void tc_step(
    int j0, int c, int tig, const float* s_theta, const float* s_bcol,
    bool b_from_smem, float2 b_const, const float (&pv)[kStrips][2],
    const float (&neg_m)[kStrips][2], float (&big)[kStrips][4],
    float (&small)[kStrips][4]) {
  const int ja = j0 + 2 * tig;
  const float2 th = *reinterpret_cast<const float2*>(s_theta + ja);
  const float2 bv =
      b_from_smem ? *reinterpret_cast<const float2*>(s_bcol + ja) : b_const;
  const uint32_t b0 = __float_as_uint(bv.x);
  const uint32_t b1 = __float_as_uint(bv.y);
#pragma unroll
  for (int s = 0; s < kStrips; ++s) {
    float w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // a0 (row gid, j), a1 (row gid + 8, j), a2, a3 the same at j + 1
      const float t = q < 2 ? th.x : th.y;
      const float f = fmaf(pv[s][q & 1], t, neg_m[s][q & 1]);
      w[q] = ex2_approx(EXP2 ? f : __fmul_rn(f, kLog2e));
    }
    if (TAIL) {
      if (ja >= c) w[0] = w[1] = 0.f;
      if (ja + 1 >= c) w[2] = w[3] = 0.f;
    }
    uint32_t a_hi[4], a_lo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) split_tf32(w[q], a_hi[q], a_lo[q]);
    mma_tf32(big[s], a_hi, b0, b1);
    mma_tf32(small[s], a_lo, b0, b1);
  }
}

// Tensor-core forms (mma, mma_exp2).  A block holds `rows_per_block` rows
// of `row_warps` warps; warp w of a row takes the groups of kStrips strips
// (64 outputs) w, w + row_warps, ...  Dynamic shared memory: per row theta
// (c_pad8 floats, zero-filled), then the B columns g_hi and g_lo
// (`b_stride` floats each, b_stride = 8 mod 32 so that the two columns'
// lanes hit different banks), then the rows' per-warp maxima and minima.
// B's column 2 (ones) and columns 3-7 (zeros) are registers.
//
// Fragment layout of m16n8k8 (gid = lane / 4, tig = lane % 4) as in the
// simple route's kernel above; D's column 0 + 1 is y's numerator (w g_hi
// and w g_lo), column 2 is z: the threads with tig == 0 hold the first, the
// threads with tig == 1 the second.
// phi of the 2 * kStrips outputs a thread of group `grp` holds (rows gid
// and gid + 8 of each strip); 0 at or beyond c.
template <typename T>
__device__ __forceinline__ void load_group_phi(const T* __restrict__ phi,
                                               long long base, int c, int grp,
                                               int gid,
                                               float (&pv)[kStrips][2]) {
#pragma unroll
  for (int s = 0; s < kStrips; ++s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = grp * kGroupRows + s * 16 + h * 8 + gid;
      pv[s][h] = r < c ? to_f32(phi[base + r]) : 0.f;
    }
  }
}

template <typename T, bool EXP2>
__global__ void __launch_bounds__(kBlockThreads)
variant_tc_kernel(const T* __restrict__ phi, const T* __restrict__ theta,
                  const T* __restrict__ g, float* __restrict__ y, int e, int c,
                  int row_warps, int rows_per_block, int c_pad8,
                  int b_stride) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int row_floats = c_pad8 + 2 * b_stride;
  const int row_threads = row_warps * 32;
  const int rib = threadIdx.x / row_threads;
  const int t = threadIdx.x - rib * row_threads;
  const long long row =
      static_cast<long long>(blockIdx.x) * rows_per_block + rib;
  const bool row_ok = row < e;
  const long long base = row * c;
  float* s_theta = smem + rib * row_floats;
  float* s_g_hi = s_theta + c_pad8;
  float* s_g_lo = s_g_hi + b_stride;
  float* red_max = smem + rows_per_block * row_floats;
  float* red_min = red_max + rows_per_block * kMaxRowWarps;
  const int lane = t & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;

  // the first group's phi is in flight while the row is staged
  float pv[kStrips][2];
  load_group_phi<T>(phi, base, row_ok ? c : 0, t >> 5, gid, pv);
  float tmax = -INFINITY;
  float tmin = INFINITY;
  for (int k = t; k < c_pad8; k += row_threads) {
    float th = 0.f, gv = 0.f;
    if (row_ok && k < c) {
      th = to_f32(theta[base + k]);
      gv = to_f32(g[base + k]);
      tmax = fmaxf(tmax, th);
      tmin = fminf(tmin, th);
    }
    uint32_t hi, lo;
    split_tf32(gv, hi, lo);
    s_theta[k] = th;
    s_g_hi[k] = __uint_as_float(hi);
    s_g_lo[k] = __uint_as_float(lo);
  }
  row_max_min(tmax, tmin, red_max, red_min, rib, t, row_warps);
  if (!row_ok) return;   // the whole row's warps leave together

  const bool b_from_smem = gid < 2;
  const float* s_bcol = gid == 0 ? s_g_hi : s_g_lo;
  const float2 b_const = gid == 2 ? make_float2(1.f, 1.f)
                                  : make_float2(0.f, 0.f);
  const int groups = (c + kGroupRows - 1) / kGroupRows;
  const int full = c & ~7;

  for (int grp = t >> 5; grp < groups; grp += row_warps) {
    // rows at or beyond c run on phi = 0 (finite weights), never written
    float neg_m[kStrips][2];
#pragma unroll
    for (int s = 0; s < kStrips; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (EXP2) pv[s][h] = __fmul_rn(pv[s][h], kLog2e);
        neg_m[s][h] = -fmaxf(__fmul_rn(pv[s][h], tmax),
                             __fmul_rn(pv[s][h], tmin));
      }
    }
    float big[kStrips][4];
    float small[kStrips][4];
#pragma unroll
    for (int s = 0; s < kStrips; ++s) {
#pragma unroll
      for (int q = 0; q < 4; ++q) big[s][q] = small[s][q] = 0.f;
    }
#pragma unroll kTcUnroll
    for (int j0 = 0; j0 < full; j0 += 8) {
      tc_step<EXP2, false>(j0, c, tig, s_theta, s_bcol, b_from_smem, b_const,
                           pv, neg_m, big, small);
    }
    if (full < c) {
      tc_step<EXP2, true>(full, c, tig, s_theta, s_bcol, b_from_smem,
                          b_const, pv, neg_m, big, small);
    }
#pragma unroll
    for (int s = 0; s < kStrips; ++s) {
      // tig 0: columns 0, 1 (the numerator); tig 1: columns 2, 3 (z, 0)
      const float c0 = big[s][0] + small[s][0];
      const float c2 = big[s][2] + small[s][2];
      const float num0 = c0 + (big[s][1] + small[s][1]);
      const float num1 = c2 + (big[s][3] + small[s][3]);
      const float z0 = __shfl_down_sync(0xffffffffu, c0, 1);
      const float z1 = __shfl_down_sync(0xffffffffu, c2, 1);
      const int r0 = grp * kGroupRows + s * 16 + gid;
      if (tig == 0) {
        if (r0 < c) y[base + r0] = num0 / z0;
        if (r0 + 8 < c) y[base + r0 + 8] = num1 / z1;
      }
    }
    load_group_phi<T>(phi, base, c, grp + row_warps, gid, pv);
  }
}

template <typename T>
cudaError_t launch_default(const T* p, const T* t, const T* gg, float* out,
                           int e, int c, int form, cudaStream_t s) {
  if (form == kExp2) return launch_simple<T>(p, t, gg, out, e, c, form, s);
  if (form == kMma || form == kMmaExp2) {
    const int groups = (c + kGroupRows - 1) / kGroupRows;
    const int row_warps = groups < kMaxRowWarps ? groups : kMaxRowWarps;
    const int rows_per_block = kMaxRowWarps / row_warps;
    const int c_pad8 = (c + 7) & ~7;
    const int b_stride = (c_pad8 - 8 + 31) / 32 * 32 + 8;
    const dim3 grid((e + rows_per_block - 1) / rows_per_block);
    const dim3 block(rows_per_block * row_warps * 32);
    const size_t smem =
        static_cast<size_t>(rows_per_block) *
        ((c_pad8 + 2 * b_stride) * sizeof(float) +
         2 * kMaxRowWarps * sizeof(float));
    if (form == kMma) {
      variant_tc_kernel<T, false><<<grid, block, smem, s>>>(
          p, t, gg, out, e, c, row_warps, rows_per_block, c_pad8, b_stride);
    } else {
      variant_tc_kernel<T, true><<<grid, block, smem, s>>>(
          p, t, gg, out, e, c, row_warps, rows_per_block, c_pad8, b_stride);
    }
    return cudaGetLastError();
  }
  const int per_thread = (c + kChains - 1) / kChains;
  const int row_threads = (per_thread + 31) / 32 * 32;
  if (row_threads > kBlockThreads) return cudaErrorInvalidValue;
  const int rows_per_block = kBlockThreads / row_threads;
  const int c_pad = (c + 1) & ~1;
  const dim3 grid((e + rows_per_block - 1) / rows_per_block);
  const dim3 block(rows_per_block * row_threads);
  const size_t smem =
      static_cast<size_t>(rows_per_block) *
      (c_pad * sizeof(float2) + 2 * kMaxRowWarps * sizeof(float));
  switch (form) {
    case kScanned:
      variant_chains_kernel<T, kScanned><<<grid, block, smem, s>>>(
          p, t, gg, out, e, c, row_threads, rows_per_block, c_pad);
      break;
    case kAnalytic:
      variant_chains_kernel<T, kAnalytic><<<grid, block, smem, s>>>(
          p, t, gg, out, e, c, row_threads, rows_per_block, c_pad);
      break;
    case kChunked:
      variant_chains_kernel<T, kChunked><<<grid, block, smem, s>>>(
          p, t, gg, out, e, c, row_threads, rows_per_block, c_pad);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* phi, const void* theta, const void* g, void* y,
                   int e, int c, int form, int route, cudaStream_t s) {
  const T* p = static_cast<const T*>(phi);
  const T* t = static_cast<const T*>(theta);
  const T* gg = static_cast<const T*>(g);
  float* out = static_cast<float*>(y);
  return route == kSimple ? launch_simple<T>(p, t, gg, out, e, c, form, s)
                          : launch_default<T>(p, t, gg, out, e, c, form, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 inputs, 1 = bfloat16 inputs.  form: the Form enum
// above.  route: 0 = the default route, 1 = "simple".  Launches on
// `stream`, does not synchronise, allocates nothing.  Returns
// cudaGetLastError().
int att_variants_forward(const void* phi, const void* theta, const void* g,
                         void* y, int e, int c, int dtype, int form, int route,
                         void* stream) {
  if (e < 0 || c < 1 || c > 1024) return cudaErrorInvalidValue;
  if (form < kScanned || form > kMmaExp2) return cudaErrorInvalidValue;
  if (route != kDefault && route != kSimple) return cudaErrorInvalidValue;
  if (e == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(
        launch<float>(phi, theta, g, y, e, c, form, route, s));
  }
  if (dtype == 1) {
    return static_cast<int>(
        launch<__nv_bfloat16>(phi, theta, g, y, e, c, form, route, s));
  }
  return cudaErrorInvalidValue;
}

const char* att_variants_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
