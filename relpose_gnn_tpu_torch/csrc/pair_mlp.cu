// Fused pair MLP for Hopper (sm_90a):
//
//     out = relu(xs @ W1a + xt @ W1b + e @ W1c + b1) @ W2 + b2
//
// over E rows (flattened node pairs), float32 [E, Dout] out.  Replaces the
// Pallas TPU kernel relpose_gnn_tpu/ops/gnn_pallas.py::_kernel (reached
// through fused_pair_mlp and pair_mlp_apply).  Like it, this kernel keeps
// two tensors out of device memory: the [E, 2D + De] concatenated input
// (the first product is three partial products against slices of W1) and
// the [E, H] hidden activation (each hidden tile lives on the SM between
// the two products, in shared memory or in registers, rounded to the
// operand type as the TPU kernel rounds it before its second product).
//
// What bounds it: operations.  At the bench shape (E = 1024, all widths
// 2048, bf16) the function needs 34 GFLOP against 47 MB of inputs and
// output, far above the card's ridge; so the tensor cores should be the
// limit, and what a design has to get out of their way is the traffic
// between the L2 cache and shared memory (every row tile streams the
// 33.5 MB of weights) and the joining of partial sums in `out`.
//
// Who owns the accumulator.  The TPU kernel revisits a VMEM-resident
// [block_e, Dout] float32 output block along a sequential hidden axis.
// Here blocks run in no order and that block does not fit an SM (128 rows
// x 2048 columns x 4 B = 1 MB), so the hidden axis is split ACROSS
// blocks: a block owns one row tile and one hidden tile, computes its
// hidden tile once (no recomputation), and adds its partial [rows, Dout]
// product into `out`, which is zeroed first; the blocks of hidden tile 0
// add b2.  The price: when H spans more than one hidden tile the order of
// the float32 sum over hidden tiles changes from run to run, so results
// agree to float32 rounding of that sum (about 1e-7 relative per tile),
// not bit for bit.
//
// Three kernels share that design, one per route (the wrapper picks the
// route from dtype and shape and hands it over; a route that does not fit
// is refused, never replaced):
//
//   fma       float32 operands: both products are register-tiled FMA
//             loops over shared-memory tiles (4 x 4 outputs a thread, 256
//             threads, 64 x 64 tiles, K step 16), full float32; partial
//             sums by atomicAdd.
//   wgmma     bfloat16 operands whose widths are multiples of 8: the
//             kernel designed for this card, described at its section
//             below: 128-row blocks of three warpgroups, wgmma fed from a
//             ring of stages that TMA fills behind mbarriers (weight
//             tiles, and operand tiles through tensor maps that broadcast
//             the node table over the pair grid), the hidden tile kept in
//             registers between the products, partial sums joined by bulk
//             reduce-add.  The hidden tile is rounded to bfloat16
//             between the products, which IS the rounding the TPU kernel
//             applies.
//   mma_sync  any other bfloat16 shape: mma.sync m16n8k16 (8 warps as
//             2 x 4 over a 64 x 128 tile, K step 32, fragments fetched
//             with ldmatrix from padded shared-memory rows, cp.async
//             double buffering with masked plain stores at ragged edges),
//             the hidden tile in shared memory as bfloat16; partial sums
//             by atomicAdd.  Every load and store is masked, so it takes
//             any width.
//
// Ragged shapes: no operand is padded; loads and stores are masked on E,
// D, De, H and Dout (fma, mma_sync) or clipped and zero-filled by the
// tensor maps and the gather (wgmma).  Rows: with nodes == 0, xs, xt and e
// are [E, .] and row p reads row p of each.  With nodes == N > 0, xs and
// xt point at the same [B * N, D] node table and pair p = (b * N + s) * N
// + t reads xs row p / N and xt row (p / N^2) * N + p % N, so the [E, D]
// broadcast copies are never materialised.  xt == nullptr skips the
// second partial product (the 'msg' form, which has no target-node
// operand).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

namespace {

constexpr int BM = 64;   // rows of a block
constexpr int BH = 64;   // hidden columns of a block
constexpr int BN = 64;   // output columns per pass of the second product
constexpr int BK = 16;   // K step of both products
constexpr int TM = 4;    // outputs per thread, rows
constexpr int TN = 4;    // outputs per thread, columns
constexpr int THREADS = (BM / TM) * (BH / TN);
constexpr int PAD = 4;   // keeps transposed tile stores off one bank

static_assert(THREADS == 256, "tile shape and thread count must agree");
static_assert(BH == BN, "the W tile buffer serves both products");
static_assert(BH % BK == 0, "the second product walks BH in BK steps");

// Source row of output row p for operand `seg` (0 = xs, 1 = xt, 2 = e).
__device__ __forceinline__ long long source_row(int seg, long long p,
                                                int nodes) {
  if (nodes == 0 || seg == 2) return p;
  if (seg == 0) return p / nodes;
  const long long nn = static_cast<long long>(nodes) * nodes;
  return (p / nn) * nodes + p % nodes;
}

// acc[TM][TN] += a_tile[k][ty * TM + i] * w_tile[k][tx * TN + j] over BK.
__device__ __forceinline__ void tile_fma(float (&acc)[TM][TN],
                                         const float (*a_tile)[BM + PAD],
                                         const float (*w_tile)[BH],
                                         int ty, int tx) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    float a[TM];
    float w[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = a_tile[k][ty * TM + i];
#pragma unroll
    for (int j = 0; j < TN; ++j) w[j] = w_tile[k][tx * TN + j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
  }
}

// W tile [BK][BH] <- w[k0 + k, c0 + c] of a row-major [k_rows, n_cols]
// matrix, zero outside it.
__device__ __forceinline__ void load_w_tile(float (*w_tile)[BH],
                                            const float* w,
                                            int k0, int k_rows, int c0,
                                            int n_cols, int tid) {
  for (int i = tid; i < BK * BH; i += THREADS) {
    const int k = i / BH;
    const int c = i % BH;
    const int gk = k0 + k;
    const int gc = c0 + c;
    float v = 0.f;
    if (gk < k_rows && gc < n_cols)
      v = w[static_cast<long long>(gk) * n_cols + gc];
    w_tile[k][c] = v;
  }
}

__global__ void __launch_bounds__(THREADS)
pair_mlp_kernel(const float* __restrict__ xs, const float* __restrict__ xt,
                const float* __restrict__ e, const float* __restrict__ w1a,
                const float* __restrict__ w1b, const float* __restrict__ w1c,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, float* __restrict__ out,
                long long n_rows, int d, int de, int h, int dout,
                int nodes) {
  __shared__ float a_tile[BK][BM + PAD];   // operand rows, transposed
  __shared__ float w_tile[BK][BH];         // weight tile of either product
  __shared__ float h_tile[BH][BM + PAD];   // hidden tile, transposed

  const int tid = threadIdx.x;
  const int tx = tid % (BH / TN);
  const int ty = tid / (BH / TN);
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int h0 = blockIdx.y * BH;

  // ---- first product: hidden tile [BM, BH] over the three operands ----
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int seg = 0; seg < 3; ++seg) {
    const float* a = seg == 0 ? xs : (seg == 1 ? xt : e);
    const float* w = seg == 0 ? w1a : (seg == 1 ? w1b : w1c);
    const int kdim = seg == 2 ? de : d;
    if (a == nullptr) continue;
    for (int k0 = 0; k0 < kdim; k0 += BK) {
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int r = i / BK;
        const int k = i % BK;
        const long long gr = row0 + r;
        const int gk = k0 + k;
        float v = 0.f;
        if (gr < n_rows && gk < kdim)
          v = a[source_row(seg, gr, nodes) * kdim + gk];
        a_tile[k][r] = v;
      }
      load_w_tile(w_tile, w, k0, kdim, h0, h, tid);
      __syncthreads();
      tile_fma(acc, a_tile, w_tile, ty, tx);
      __syncthreads();
    }
  }

  // ---- bias, ReLU; the hidden tile goes to shared memory ----
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = tx * TN + j;
    const int gc = h0 + c;
    const float bias = gc < h ? b1[gc] : 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float v = fmaxf(acc[i][j] + bias, 0.f);
      h_tile[c][ty * TM + i] = gc < h ? v : 0.f;
    }
  }
  __syncthreads();

  // ---- second product: out[rows, :] += hidden tile @ W2[h0:h0+BH, :] ----
  for (int n0 = 0; n0 < dout; n0 += BN) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < BH; k0 += BK) {
      load_w_tile(w_tile, w2, h0 + k0, h, n0, dout, tid);
      __syncthreads();
      tile_fma(acc, h_tile + k0, w_tile, ty, tx);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long gr = row0 + ty * TM + i;
      if (gr >= n_rows) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gc = n0 + tx * TN + j;
        if (gc >= dout) continue;
        float v = acc[i][j];
        if (blockIdx.y == 0) v += b2[gc];
        atomicAdd(out + gr * dout + gc, v);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MBM = 64;          // rows of a block
constexpr int MBH = 128;         // hidden columns of a block
constexpr int MBN = 128;         // output columns per pass
constexpr int MBK = 32;          // K step of both products
constexpr int A_LD = MBK + 8;    // 80-byte rows: ldmatrix hits 32 banks
constexpr int W_LD = MBN + 8;    // 272-byte rows, likewise
constexpr int H_LD = MBH + 8;
constexpr int MTHREADS = 256;    // 8 warps: 2 over rows x 4 over columns

static_assert(MBH == MBN, "the W tile buffer serves both products");
static_assert(MBH % MBK == 0, "the second product walks MBH in MBK steps");

typedef unsigned short bf16_bits;  // a bfloat16 moved as its 16 bits

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 8 consecutive 16-bit values src[0..7] -> dst (16-byte aligned shared
// memory), zero where !row_ok or past `remaining`.  When all 8 are there
// and src is 16-byte aligned it is one asynchronous 16-byte copy
// (cp.async, completed by the caller's wait); else a plain masked store.
// Both are visible to the block after the wait and a __syncthreads().
__device__ __forceinline__ void stage8(const bf16_bits* src, bool row_ok,
                                       long long remaining, bf16_bits* dst) {
  if (row_ok && remaining >= 8 &&
      (reinterpret_cast<unsigned long long>(src) & 15ull) == 0ull) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :
                 : "r"(smem_addr(dst)), "l"(src)
                 : "memory");
    return;
  }
  union {
    uint4 v;
    bf16_bits h[8];
  } u;
  u.v = make_uint4(0u, 0u, 0u, 0u);
  if (row_ok) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < remaining) u.h[i] = src[i];
  }
  *reinterpret_cast<uint4*>(dst) = u.v;
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `Pending` of this thread's copy groups are in flight.
template <int Pending>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// W tile [MBK][MBN] <- w[k0 + k, c0 + c] of a row-major [k_rows, n_cols]
// bfloat16 matrix, zero outside it.
__device__ __forceinline__ void stage_w_tile(bf16_bits (*w_s)[W_LD],
                                             const bf16_bits* w, int k0,
                                             int k_rows, int c0, int n_cols,
                                             int tid) {
#pragma unroll
  for (int i = 0; i < (MBK * MBN / 8) / MTHREADS; ++i) {
    const int idx = tid + i * MTHREADS;
    const int k = idx / (MBN / 8);
    const int c8 = (idx % (MBN / 8)) * 8;
    const int gk = k0 + k;
    const int gc = c0 + c8;
    stage8(w + static_cast<long long>(gk) * n_cols + gc, gk < k_rows,
           static_cast<long long>(n_cols) - gc, &w_s[k][c8]);
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[16 x 8] += a[16 x 16] * b[16 x 8], bf16 operands, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One MBK step of a warp's 32 x 32 tile: A rows from `a_rows` (row-major,
// `a_ld` elements a row, starting at column `a_col`), B from the W tile.
// Lane l addresses row (l & 7) of 8 x 8 matrix (l >> 3): matrices 0/1 are
// the two row (A) or k (B) halves, 2/3 the second k (A) or column (B) half.
__device__ __forceinline__ void warp_mma_step(float (&acc)[2][4][4],
                                              const bf16_bits* a_rows,
                                              int a_ld, int a_col,
                                              const bf16_bits (*w_s)[W_LD],
                                              int warp_n, int lane) {
  const int r = lane & 7;
  const int mat = lane >> 3;
#pragma unroll
  for (int ks = 0; ks < MBK; ks += 16) {
    unsigned a[2][4];
    unsigned b[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4(a[mi], smem_addr(
          a_rows + (mi * 16 + (mat & 1) * 8 + r) * a_ld + a_col + ks +
          (mat >> 1) * 8));
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
      ldmatrix_x4_trans(b[nj], smem_addr(
          &w_s[ks + (mat & 1) * 8 + r][warp_n * 32 + nj * 16 +
                                       (mat >> 1) * 8]));
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_bf16(acc[mi][ni], a[mi], b[ni >> 1][(ni & 1) * 2],
                 b[ni >> 1][(ni & 1) * 2 + 1]);
  }
}

__global__ void __launch_bounds__(MTHREADS)
pair_mlp_bf16_kernel(const bf16_bits* __restrict__ xs,
                     const bf16_bits* __restrict__ xt,
                     const bf16_bits* __restrict__ e,
                     const bf16_bits* __restrict__ w1a,
                     const bf16_bits* __restrict__ w1b,
                     const bf16_bits* __restrict__ w1c,
                     const float* __restrict__ b1,
                     const bf16_bits* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ out,
                     long long n_rows, int d, int de, int h, int dout,
                     int nodes) {
  // two buffers each for the operand and weight tiles: the copies of
  // step s + 1 are in flight while the tensor cores work on step s
  __shared__ __align__(16) bf16_bits a_s[2][MBM][A_LD];  // operand rows
  __shared__ __align__(16) bf16_bits w_s[2][MBK][W_LD];  // weight tiles
  __shared__ __align__(16) bf16_bits h_s[MBM][H_LD];     // hidden, bf16

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp_m = (tid >> 5) >> 2;   // 0..1: rows warp_m * 32
  const int warp_n = (tid >> 5) & 3;    // 0..3: columns warp_n * 32
  const int g = lane >> 2;              // fragment row
  const int t = lane & 3;               // fragment column pair
  const long long row0 = static_cast<long long>(blockIdx.x) * MBM;
  const int h0 = blockIdx.y * MBH;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;

  // ---- first product: hidden tile [MBM, MBH] over the three operands ----
  // Its K steps, operand after operand, form one sequence of `total`
  // steps so that the double buffering runs across operand boundaries.
  const int a_r = tid / (MBK / 8);            // staged row of this thread
  const int a_c8 = (tid % (MBK / 8)) * 8;     // and its 8 columns
  const long long gr_stage = row0 + a_r;
  const bool row_ok = gr_stage < n_rows;
  const int steps_x = (d + MBK - 1) / MBK;
  const int steps_xt = xt != nullptr ? steps_x : 0;
  const int total = steps_x + steps_xt + (de + MBK - 1) / MBK;

  auto issue_first = [&](int step, int buf) {
    const int seg = step < steps_x ? 0 : (step < steps_x + steps_xt ? 1 : 2);
    const int k0 =
        (step - (seg == 0 ? 0 : (seg == 1 ? steps_x : steps_x + steps_xt))) *
        MBK;
    const bf16_bits* a = seg == 0 ? xs : (seg == 1 ? xt : e);
    const bf16_bits* w = seg == 0 ? w1a : (seg == 1 ? w1b : w1c);
    const int kdim = seg == 2 ? de : d;
    const bf16_bits* a_row =
        a + (row_ok ? source_row(seg, gr_stage, nodes) : 0) * kdim;
    stage8(a_row + k0 + a_c8, row_ok,
           static_cast<long long>(kdim) - (k0 + a_c8), &a_s[buf][a_r][a_c8]);
    stage_w_tile(w_s[buf], w, k0, kdim, h0, h, tid);
    async_commit();
  };

  issue_first(0, 0);
  for (int step = 0; step < total; ++step) {
    const int buf = step & 1;
    if (step + 1 < total) {
      issue_first(step + 1, buf ^ 1);
      async_wait<1>();
    } else {
      async_wait<0>();
    }
    __syncthreads();
    warp_mma_step(acc, &a_s[buf][warp_m * 32][0], A_LD, 0, w_s[buf], warp_n,
                  lane);
    __syncthreads();   // all warps are done with `buf` before it refills
  }

  // ---- second product: out[rows, :] += hidden tile @ W2[h0:h0+MBH, :] ----
  // Its steps run over (output chunk, K step of the hidden tile); the
  // first W2 tile is already on its way while the hidden tile is written.
  constexpr int k_steps = MBH / MBK;
  const int total2 = ((dout + MBN - 1) / MBN) * k_steps;
  auto issue_second = [&](int step, int buf) {
    stage_w_tile(w_s[buf], w2, h0 + (step % k_steps) * MBK, h,
                 (step / k_steps) * MBN, dout, tid);
    async_commit();
  };
  issue_second(0, 0);

  // bias, ReLU; the hidden tile goes to shared memory as bfloat16
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = warp_n * 32 + ni * 8 + 2 * t;
      const int gc = h0 + col;
      const float bias0 = gc < h ? b1[gc] : 0.f;
      const float bias1 = gc + 1 < h ? b1[gc + 1] : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = warp_m * 32 + mi * 16 + g + half * 8;
        const float v0 =
            gc < h ? fmaxf(acc[mi][ni][half * 2] + bias0, 0.f) : 0.f;
        const float v1 =
            gc + 1 < h ? fmaxf(acc[mi][ni][half * 2 + 1] + bias1, 0.f) : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(&h_s[row][col]) =
            __floats2bfloat162_rn(v0, v1);
#pragma unroll
        for (int c = 0; c < 2; ++c) acc[mi][ni][half * 2 + c] = 0.f;
      }
    }

  for (int step = 0; step < total2; ++step) {
    const int buf = step & 1;
    if (step + 1 < total2) {
      issue_second(step + 1, buf ^ 1);
      async_wait<1>();
    } else {
      async_wait<0>();
    }
    __syncthreads();   // also orders the hidden tile's stores before reads
    warp_mma_step(acc, &h_s[warp_m * 32][0], H_LD, (step % k_steps) * MBK,
                  w_s[buf], warp_n, lane);
    __syncthreads();
    if (step % k_steps != k_steps - 1) continue;
    // this output chunk is complete: add it into `out`, start the next
    const int n0 = (step / k_steps) * MBN;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long gr = row0 + warp_m * 32 + mi * 16 + g + half * 8;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int gc = n0 + warp_n * 32 + ni * 8 + 2 * t + c;
            float v = acc[mi][ni][half * 2 + c];
            acc[mi][ni][half * 2 + c] = 0.f;
            if (gr >= n_rows || gc >= dout) continue;
            if (blockIdx.y == 0) v += b2[gc];
            atomicAdd(out + gr * dout + gc, v);
          }
      }
  }
}

// Zeroes `out`, then launches the FMA or the mma.sync kernel.
template <typename T>
cudaError_t launch(const void* xs, const void* xt, const void* e,
                   const void* w1a, const void* w1b, const void* w1c,
                   const float* b1, const void* w2, const float* b2,
                   float* out, long long n_rows, int d, int de, int h,
                   int dout, int nodes, cudaStream_t s) {
  constexpr bool kTensorCores = sizeof(T) == 2;
  constexpr int rows = kTensorCores ? MBM : BM;
  constexpr int cols = kTensorCores ? MBH : BH;
  const long long row_tiles = (n_rows + rows - 1) / rows;
  const int h_tiles = (h + cols - 1) / cols;
  if (row_tiles > 2147483647LL || h_tiles > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(n_rows) * dout * sizeof(float), s);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(row_tiles), h_tiles);
  if constexpr (kTensorCores) {
    pair_mlp_bf16_kernel<<<grid, MTHREADS, 0, s>>>(
        static_cast<const bf16_bits*>(xs), static_cast<const bf16_bits*>(xt),
        static_cast<const bf16_bits*>(e), static_cast<const bf16_bits*>(w1a),
        static_cast<const bf16_bits*>(w1b),
        static_cast<const bf16_bits*>(w1c), b1,
        static_cast<const bf16_bits*>(w2), b2, out, n_rows, d, de, h, dout,
        nodes);
  } else {
    pair_mlp_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(xs), static_cast<const float*>(xt),
        static_cast<const float*>(e), static_cast<const float*>(w1a),
        static_cast<const float*>(w1b), static_cast<const float*>(w1c), b1,
        static_cast<const float*>(w2), b2, out, n_rows, d, de, h, dout,
        nodes);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 on wgmma: warp-specialised, a TMA weight ring, bulk reduce-add
// ---------------------------------------------------------------------------
//
// A block is three warpgroups over 128 rows and one hidden tile of BH
// columns.  Warpgroups 0 and 1 (the consumers, 64 rows each) issue wgmma;
// warpgroup 2 (the producer) only moves data into a ring of stages in
// dynamic shared memory (six of 32 KB with a hidden tile of 128 columns,
// four of 48 KB with one of 256).  A stage holds an operand tile A [128 rows][64 k]
// and a weight tile W [64 k][BH n] as BH / 64 boxes of [64 k][64 n], every
// row 128 bytes in the 128-byte swizzle (the 16-byte chunk c of row r lies
// at chunk c ^ (r % 8)), and has two mbarriers: `full` (the producer's 128
// threads and the bytes that TMA copies have arrived) and `empty` (the eight
// consumer warps are done reading).  No __syncthreads() after the roles
// split.
//
//   W tiles   one thread issues cp.async.bulk.tensor.2d (TMA) per box; the
//             tensor map swizzles, and zero-fills outside the matrix, which
//             takes the place of masks on D, De, H and Dout.  Weights are
//             [in, out] row-major, so B is N-contiguous: the transpose-B
//             bit of wgmma is set, nothing is transposed in memory.
//   A tiles   also by TMA, one box of [128 rows][64 k] a stage, wherever
//             the tile's rows are a box of the operand.  Direct rows
//             (nodes == 0) and the edge operand always are.  Row p of the
//             pair grid reads node row source_row(p), which repeats: the
//             node table is then described by a 4-d tensor map with a
//             stride of ZERO along the repeated pair index (xs: [node][t
//             repeated][k]; xt: [graph][s repeated][t][k]), so that the
//             copy engine does the broadcast while it fills the tile, and
//             the 128 pair rows of a block are a box of that view whenever
//             the node count is a power of two up to 128.  For any other
//             node count the producer's threads gather the tile, 16 bytes
//             per (row, 8 columns) with cp.async to the swizzled address
//             (zero-filled past E and past the operand's width), and
//             arrive on `full` through cp.async.mbarrier.arrive.noinc; the
//             consumers fence the async proxy after the wait, since
//             cp.async writes through the generic proxy and wgmma reads
//             through the async one.
//   hidden    the first product's accumulator [64][BH] stays in registers:
//             bias, ReLU and the rounding to bfloat16 happen there, and
//             the m64nNk16 accumulator fragment repacks to m64k16 A
//             fragments without leaving the thread, so the second product
//             takes A from registers.  Neither the concat nor the hidden
//             tensor exists anywhere, not even in shared memory.
//   out       each finished [64][128] float32 chunk of the second product
//             goes to a staging tile (four [64][32] boxes, swizzled, so
//             the stores are conflict-free; they lie in the ring's A
//             tiles, which the second product does not use, so the ring
//             can take all of shared memory) and from there to `out` with
//             cp.reduce.async.bulk.tensor (add): the copy engine joins the
//             partial sums of the hidden tiles, and the tensor map clips
//             the ragged E and Dout edges.  No scalar atomics.
//   raster    the grid is one-dimensional and decoded in the kernel; with
//             more than one wave of blocks the hidden tile is the fast
//             index: the blocks resident together share their A rows and
//             add into the same few row tiles of `out` while those are in
//             the L2 cache (see launch_wgmma_tile).
//
// Takes bfloat16 operands whose widths D, De, H and Dout are multiples of 8
// (16-byte row strides for the tensor maps and the gather) and 16-byte
// aligned pointers; anything else is the mma.sync kernel's.

constexpr int WROWS = 128;          // rows of a block
constexpr int WBK = 64;             // K step: one swizzled 128-byte row
constexpr int WBN = 128;            // output columns per chunk, second product
constexpr int WTHREADS = 384;       // two consumer warpgroups and a producer
constexpr int PRODUCER_THREADS = 128;
constexpr int CONSUMER_WARPS = 8;
constexpr int A_TILE_BYTES = WROWS * WBK * 2;       // 16 KB
constexpr int W_BOX_BYTES = 64 * 64 * 2;            // [64 k][64 n] bf16, 8 KB
constexpr int OUT_BOX_BYTES = 64 * 32 * 4;          // [64 rows][32 n] f32, 8 KB
constexpr int OUT_BOXES = WBN / 32;                 // staging boxes a chunk
constexpr int MAX_STAGES = 8;
// a warpgroup's 64 rows of an A tile are exactly one staging box
static_assert(A_TILE_BYTES / 2 == OUT_BOX_BYTES, "staging reuses A tiles");

// Build-time settings of the design's steps, for the bench that times
// them (benchmarks/bench_pair_mlp_steps.py); the defaults are the kernel.
#ifndef PAIR_STAGES_128
#define PAIR_STAGES_128 6           // ring depth, hidden tile 128
#endif
#ifndef PAIR_STAGES_256
#define PAIR_STAGES_256 4           // ring depth, hidden tile 256
#endif
#ifndef PAIR_FORCE_BH
#define PAIR_FORCE_BH 0             // 128 or 256: that hidden tile always
#endif
#ifndef PAIR_GATHER_ALWAYS
#define PAIR_GATHER_ALWAYS 0        // 1: A tiles by the cp.async gather only
#endif
#ifndef PAIR_SCALAR_ATOMICS
#define PAIR_SCALAR_ATOMICS 0       // 1: partial sums by atomicAdd per float
#endif

template <int BH>
struct Ring {
  static constexpr int kWTileBytes = (BH / 64) * W_BOX_BYTES;
  static constexpr int kStageBytes = A_TILE_BYTES + kWTileBytes;
  static constexpr int kStages = BH == 128 ? PAIR_STAGES_128 : PAIR_STAGES_256;
  static_assert(kStages >= 2 && kStages <= MAX_STAGES, "ring depth");
  // The second product takes A from registers, so the A tiles of the ring
  // are idle then: a consumer warpgroup stages its output chunk in its own
  // 64 rows of the first OUT_BOXES stages' A tiles (it has read them for
  // the last time, and nobody else reads or writes those rows).  A ring
  // shallower than that gets staging room of its own behind the ring.
  static constexpr bool kStageInRing = kStages >= OUT_BOXES;
  // 1 KB of slack to align the ring to the swizzle's 1024 bytes
  static constexpr int kSmemBytes =
      kStages * kStageBytes + 1024 +
      (kStageInRing ? 0 : 2 * OUT_BOXES * OUT_BOX_BYTES);
};

#ifndef PAIR_RASTER_ROWS_FAST
#define PAIR_RASTER_ROWS_FAST -1    // 1 / 0: row / hidden tile always fast
#endif

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Spins until the phase of parity `parity` of the barrier has completed.
// A wait that outlasts 2^28 polls (tens of seconds; a launch takes
// milliseconds) traps, so that a fault in the ring is a launch error and
// not a hung card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  unsigned polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// This thread's arrival, delivered when all its earlier cp.async are done.
__device__ __forceinline__ void cp_async_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// 16 bytes global -> shared past L1, or 16 zero bytes when !ok.
__device__ __forceinline__ void cp_async_16_or_zero(unsigned dst,
                                                    const void* src,
                                                    bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// One box of `map` at (inner, outer) -> shared, its bytes counted on `bar`.
__device__ __forceinline__ void tma_load_box(unsigned dst,
                                             const CUtensorMap* map,
                                             unsigned bar, int inner,
                                             int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(inner),
      "r"(outer)
      : "memory");
}

// The same for a 4-d map, coordinates innermost first.
__device__ __forceinline__ void tma_load_box_4d(unsigned dst,
                                                const CUtensorMap* map,
                                                unsigned bar, int c0, int c1,
                                                int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One float32 box shared -> `map` at (inner, outer), added into memory.
__device__ __forceinline__ void tma_reduce_add_box(const CUtensorMap* map,
                                                   unsigned src, int inner,
                                                   int outer) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.tile.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<unsigned long long>(map)),
      "r"(src), "r"(inner), "r"(outer)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until this thread's bulk operations have read their shared-memory source.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's generic-proxy accesses to shared memory (and those
// it has observed) before later async-proxy ones (wgmma, bulk copies).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier_128(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending)
               : "memory");
}

// Keeps the compiler from moving accumulator accesses across the wgmma
// instructions that read and write them asynchronously.
template <int N>
__device__ __forceinline__ void fence_registers(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets in 16-byte units, layout type 1 at bit 62.
__device__ __forceinline__ unsigned long long smem_desc(unsigned addr,
                                                        unsigned lbo_bytes,
                                                        unsigned sbo_bytes) {
  return static_cast<unsigned long long>((addr & 0x3FFFFu) >> 4) |
         (static_cast<unsigned long long>(lbo_bytes >> 4) << 16) |
         (static_cast<unsigned long long>(sbo_bytes >> 4) << 32) |
         (1ull << 62);
}

// d[64 x 128] += A[64 x 16] * B[16 x 128]: A (K-major) and B (N-major,
// hence the transpose bit) from shared memory through their descriptors.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], unsigned long long a,
                                         unsigned long long b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 256] += A[64 x 16] * B[16 x 256]: A (K-major) and B (N-major,
// hence the transpose bit) from shared memory through their descriptors.
__device__ __forceinline__ void wgmma_ss(float (&d)[128], unsigned long long a,
                                         unsigned long long b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// The same with A from registers: a[4] is the thread's m64k16 bf16 fragment.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const unsigned* a,
                                         unsigned long long b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int BH>
__global__ void __launch_bounds__(WTHREADS, 1)
pair_mlp_wgmma_kernel(const bf16_bits* __restrict__ xs,
                      const bf16_bits* __restrict__ xt,
                      const bf16_bits* __restrict__ e,
                      const float* __restrict__ b1,
                      const float* __restrict__ b2,
                      float* __restrict__ out_scalar,   // PAIR_SCALAR_ATOMICS
                      const __grid_constant__ CUtensorMap map_w1a,
                      const __grid_constant__ CUtensorMap map_w1b,
                      const __grid_constant__ CUtensorMap map_w1c,
                      const __grid_constant__ CUtensorMap map_w2,
                      const __grid_constant__ CUtensorMap map_out,
                      const __grid_constant__ CUtensorMap map_xs,
                      const __grid_constant__ CUtensorMap map_xt,
                      const __grid_constant__ CUtensorMap map_e,
                      int a_by_tma,   // bit seg: operand seg's tiles are boxes
                      long long n_rows, int d, int de, int h, int dout,
                      int nodes, int h_tiles, int rows_fast) {
  using R = Ring<BH>;
  constexpr int kStages = R::kStages;
  constexpr int kSteps2 = BH / WBK;   // K steps of the second product

  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) unsigned long long bars[2 * MAX_STAGES];
  __shared__ int src_rows[3][WROWS];
  const unsigned ring = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const unsigned full0 = smem_addr(&bars[0]);
  const unsigned empty0 = smem_addr(&bars[MAX_STAGES]);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, PRODUCER_THREADS + 1);
      mbar_init(empty0 + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int row_tiles = gridDim.x / h_tiles;
  const int row_tile =
      rows_fast ? blockIdx.x % row_tiles : blockIdx.x / h_tiles;
  const int h_tile =
      rows_fast ? blockIdx.x / row_tiles : blockIdx.x % h_tiles;
  const long long row0 = static_cast<long long>(row_tile) * WROWS;
  const int h0 = h_tile * BH;

  const int steps_x = (d + WBK - 1) / WBK;
  const int steps_e = (de + WBK - 1) / WBK;
  const int total1 = steps_x * (xt != nullptr ? 2 : 1) + steps_e;
  const int chunks = (dout + WBN - 1) / WBN;

  int stage = 0;
  unsigned phase = 0;
  auto advance = [&]() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1u;
    }
  };

  if (tid >= 2 * 128) {
    // ===================== producer warpgroup =====================
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int pt = tid - 2 * 128;
    const int chunk16 = pt & 7;         // this thread's 16-byte column
    const int r_first = pt >> 3;        // its rows: r_first + 16 * i
    const unsigned a_off =
        r_first * 128 + ((chunk16 ^ (r_first & 7)) << 4);
    // the source row of each of the block's rows, per operand; -1 past E
    {
      const long long gr = row0 + pt;
#pragma unroll
      for (int seg = 0; seg < 3; ++seg)
        src_rows[seg][pt] =
            gr < n_rows ? static_cast<int>(source_row(seg, gr, nodes)) : -1;
    }
    named_barrier_128(3);

    for (int seg = 0; seg < 3; ++seg) {
      if (seg == 1 && xt == nullptr) continue;
      const bf16_bits* a = seg == 0 ? xs : (seg == 1 ? xt : e);
      const CUtensorMap* map =
          seg == 0 ? &map_w1a : (seg == 1 ? &map_w1b : &map_w1c);
      const int kdim = seg == 2 ? de : d;
      // where the block's 128 rows start in the operand's 4-d view (see
      // encode_operand_map): [row], [node][repeat] or [graph][s][t]
      const bool by_tma = (a_by_tma >> seg) & 1;
      const CUtensorMap* a_map =
          seg == 0 ? &map_xs : (seg == 1 ? &map_xt : &map_e);
      int c1 = static_cast<int>(row0), c2 = 0, c3 = 0;
      if (nodes != 0 && seg == 0) {
        c1 = 0;
        c2 = static_cast<int>(row0 / nodes);
      } else if (nodes != 0 && seg == 1) {
        const long long nn = static_cast<long long>(nodes) * nodes;
        c1 = 0;
        c2 = static_cast<int>((row0 % nn) / nodes);
        c3 = static_cast<int>(row0 / nn);
      }
      for (int k0 = 0; k0 < kdim; k0 += WBK) {
        const unsigned a_tile = ring + stage * R::kStageBytes;
        const unsigned full = full0 + 8 * stage;
        mbar_wait(empty0 + 8 * stage, phase ^ 1u);
        if (pt == 0) {
          mbar_arrive_expect_tx(
              full, R::kWTileBytes + (by_tma ? A_TILE_BYTES : 0));
#pragma unroll
          for (int b = 0; b < BH / 64; ++b)
            tma_load_box(a_tile + A_TILE_BYTES + b * W_BOX_BYTES, map, full,
                         h0 + 64 * b, k0);
          if (by_tma) tma_load_box_4d(a_tile, a_map, full, k0, c1, c2, c3);
        }
        if (by_tma) {
          mbar_arrive(full);
          advance();
          continue;
        }
        const int kc = k0 + chunk16 * 8;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int src_row = src_rows[seg][r_first + 16 * i];
          const bool ok = src_row >= 0 && kc < kdim;
          const bf16_bits* src =
              ok ? a + static_cast<long long>(src_row) * kdim + kc : a;
          cp_async_16_or_zero(a_tile + a_off + i * (16 * 128), src, ok);
        }
        cp_async_arrive(full);
        advance();
      }
    }
    // second product: W2[h0 + 64 ks .., n0 ..] tiles, two boxes a stage
    for (int chunk = 0; chunk < chunks; ++chunk) {
      for (int ks = 0; ks < kSteps2; ++ks) {
        const unsigned w_tile = ring + stage * R::kStageBytes + A_TILE_BYTES;
        const unsigned full = full0 + 8 * stage;
        mbar_wait(empty0 + 8 * stage, phase ^ 1u);
        if (pt == 0) {
          mbar_arrive_expect_tx(full, (WBN / 64) * W_BOX_BYTES);
#pragma unroll
          for (int b = 0; b < WBN / 64; ++b)
            tma_load_box(w_tile + b * W_BOX_BYTES, &map_w2, full,
                         chunk * WBN + 64 * b, h0 + ks * WBK);
        }
        mbar_arrive(full);
        advance();
      }
    }
  } else {
    // ===================== consumer warpgroups =====================
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = tid >> 7;            // rows wg * 64 .. + 63 of the block
    const int warp = (tid >> 5) & 3;    // rows warp * 16 .. + 15 of those
    const int lane = tid & 31;
    const int g = lane >> 2;            // fragment row (and row + 8)
    const int t = lane & 3;             // fragment column pair

    // ---- first product: hidden tile [64, BH] in registers ----
    float acc[BH / 2];
#pragma unroll
    for (int i = 0; i < BH / 2; ++i) acc[i] = 0.f;
    int prev_stage = 0;
    for (int step = 0; step < total1; ++step) {
      const unsigned a_tile = ring + stage * R::kStageBytes;
      mbar_wait(full0 + 8 * stage, phase);
      fence_proxy_async();
      // A: K-major, 8-row groups 1024 bytes apart; B: N-major, 64-column
      // boxes W_BOX_BYTES apart, 8-k groups 1024 bytes apart
      const unsigned long long da =
          smem_desc(a_tile + wg * (64 * 128), 16, 1024);
      const unsigned long long db =
          smem_desc(a_tile + A_TILE_BYTES, W_BOX_BYTES, 1024);
      fence_registers(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WBK / 16; ++kk)
        wgmma_ss(acc, da + kk * (32 >> 4), db + kk * ((16 * 128) >> 4));
      wgmma_commit();
      fence_registers(acc);
      if (step > 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty0 + 8 * prev_stage);
      }
      prev_stage = stage;
      advance();
    }
    wgmma_wait<0>();
    fence_registers(acc);
    if (lane == 0) mbar_arrive(empty0 + 8 * prev_stage);

    // ---- bias, ReLU, bfloat16: accumulator -> A fragments ----
    // acc[4 j + 2 half + c] is row g + 8 half, column 8 j + 2 t + c; the
    // m64k16 A fragment of k block kb is {hp[4 kb], .. + 3} = (row g, k
    // 2t..), (row g + 8, k 2t..), (row g, k 8 + 2t..), (row g + 8, ..).
    unsigned hp[BH / 4];
#pragma unroll
    for (int j = 0; j < BH / 8; ++j) {
      const int gc = h0 + 8 * j + 2 * t;
      const float2 bias = gc < h ? *reinterpret_cast<const float2*>(b1 + gc)
                                 : make_float2(0.f, 0.f);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            fmaxf(acc[4 * j + 2 * half] + bias.x, 0.f),
            fmaxf(acc[4 * j + 2 * half + 1] + bias.y, 0.f));
        hp[2 * j + half] = *reinterpret_cast<const unsigned*>(&v);
      }
    }

    // ---- second product: out[rows, chunk] += hidden @ W2[h tile, chunk] ----
    // staging box b of this warpgroup (see Ring::kStageInRing)
    auto out_box = [&](int b) -> unsigned {
      if (R::kStageInRing)
        return ring + b * R::kStageBytes + wg * OUT_BOX_BYTES;
      return ring + kStages * R::kStageBytes +
             (wg * OUT_BOXES + b) * OUT_BOX_BYTES;
    };
    const bool issuer = warp == 0 && lane == 0;
    const int out_row = static_cast<int>(row0) + wg * 64;
    for (int chunk = 0; chunk < chunks; ++chunk) {
      float acc2[WBN / 2];
#pragma unroll
      for (int i = 0; i < WBN / 2; ++i) acc2[i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kSteps2; ++ks) {
        const unsigned w_tile = ring + stage * R::kStageBytes + A_TILE_BYTES;
        mbar_wait(full0 + 8 * stage, phase);
        const unsigned long long db = smem_desc(w_tile, W_BOX_BYTES, 1024);
        fence_registers(acc2);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WBK / 16; ++kk)
          wgmma_rs(acc2, &hp[(ks * (WBK / 16) + kk) * 4],
                   db + kk * ((16 * 128) >> 4));
        wgmma_commit();
        wgmma_wait<0>();
        fence_registers(acc2);
        if (lane == 0) mbar_arrive(empty0 + 8 * stage);
        advance();
      }
      const int n0 = chunk * WBN;
#if PAIR_SCALAR_ATOMICS
#pragma unroll
      for (int j = 0; j < WBN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const long long gr = out_row + warp * 16 + g + 8 * (i >> 1);
          const int gc = n0 + 8 * j + 2 * t + (i & 1);
          if (gr >= n_rows || gc >= dout) continue;
          atomicAdd(out_scalar + gr * dout + gc,
                    acc2[4 * j + i] + (h_tile == 0 ? b2[gc] : 0.f));
        }
      continue;
#endif
      // the staging tile is free once the last chunk's reduce has read it
      if (issuer) bulk_wait_read();
      named_barrier_128(1 + wg);
#pragma unroll
      for (int j = 0; j < WBN / 8; ++j) {
        const int col = 8 * j + 2 * t;            // column in the chunk
        float2 bias = make_float2(0.f, 0.f);
        if (h_tile == 0 && n0 + col < dout)
          bias = *reinterpret_cast<const float2*>(b2 + n0 + col);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = warp * 16 + g + 8 * half;   // row % 8 == g
          const unsigned addr =
              out_box(j >> 2) + row * 128 +
              ((((2 * (j & 3)) + (t >> 1)) ^ g) << 4) + (t & 1) * 8;
          asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
                       "f"(acc2[4 * j + 2 * half] + bias.x),
                       "f"(acc2[4 * j + 2 * half + 1] + bias.y)
                       : "memory");
        }
      }
      fence_proxy_async();
      named_barrier_128(1 + wg);
      if (issuer && out_row < n_rows) {
#pragma unroll
        for (int b = 0; b < OUT_BOXES; ++b)
          if (n0 + 32 * b < dout)
            tma_reduce_add_box(&map_out, out_box(b), n0 + 32 * b, out_row);
        bulk_commit();
      }
    }
    if (issuer) bulk_wait_read();
  }
}

// cuTensorMapEncodeTiled, looked up in libcuda, which the CUDA runtime has
// already loaded into the process: nothing links against it.
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiledFn>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// Tensor map of `rank` (2 or 4) dimensions, innermost first: `dims`
// extents, `strides` the byte strides of dimensions 1 and up, `box` the
// tile; rows of 128 bytes in the 128-byte swizzle.  The copy instruction
// that uses a map names the same rank.
bool encode_map_nd(CUtensorMap* map, CUtensorMapDataType type, int rank,
                   const void* base, const cuuint64_t* dims,
                   const cuuint64_t* strides, const cuuint32_t* box,
                   CUtensorMapL2promotion promotion) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(base), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, promotion,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// 2-d map of a row-major [outer, inner] matrix cut into boxes of
// [box_outer, box_inner].
bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                const void* base, long long outer, int inner, int box_outer,
                int box_inner, CUtensorMapL2promotion promotion) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  return encode_map_nd(map, type, 2, base, dims, strides, box, promotion);
}

// Tensor map under which the 128 rows that a block reads of operand `seg`
// (0 = xs, 1 = xt, 2 = e; [rows, kdim] bfloat16 at `base`) are one box
// of [128][64 k]; false where they are not, and the kernel gathers.
//   direct rows, and e:  [row][k], box 128 rows.
//   xs, nodes = N:       pair p reads node p / N: the table seen as
//                        [node][t][k] with stride 0 along t, box [128 / N
//                        nodes][N][64].
//   xt, nodes = N:       pair p = (b N + s) N + t reads node b N + t: the
//                        table seen as [graph b][s][t][k] with stride 0
//                        along s, box [whole graphs][N][N][64] when N^2 <=
//                        128, else [1][128 / N][N][64].
// The boxes tile the pair grid exactly when N is a power of two up to 128.
bool encode_operand_map(CUtensorMap* map, int seg, const void* base,
                        long long n_rows, int kdim, int nodes) {
  if (PAIR_GATHER_ALWAYS || base == nullptr) return false;
  const bool direct = nodes == 0 || seg == 2;
  if (!direct && (nodes > WROWS || (nodes & (nodes - 1)) != 0)) return false;
  const cuuint64_t k = static_cast<cuuint64_t>(kdim);
  const cuuint64_t rows = static_cast<cuuint64_t>(n_rows);
  const cuuint64_t row_bytes = k * 2;
  const cuuint64_t n = direct ? 1 : static_cast<cuuint64_t>(nodes);
  const cuuint32_t un = static_cast<cuuint32_t>(n);
  const cuuint64_t graphs = rows / (n * n);
  const bool few = un * un <= WROWS;   // a block holds whole graphs
  cuuint64_t dims[4] = {k, rows, 1, 1};
  cuuint64_t strides[3] = {row_bytes, row_bytes, row_bytes};
  cuuint32_t box[4] = {WBK, WROWS, 1, 1};
  if (!direct && seg == 0) {           // [node][t, stride 0][k]
    dims[1] = n, dims[2] = graphs * n;
    strides[0] = 0;
    box[1] = un, box[2] = WROWS / un;
  } else if (!direct) {                // [graph][s, stride 0][t][k]
    dims[1] = n, dims[2] = n, dims[3] = graphs;
    strides[1] = 0, strides[2] = n * row_bytes;
    box[1] = un, box[2] = few ? un : WROWS / un;
    box[3] = few ? WROWS / (un * un) : 1;
  }
  return encode_map_nd(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims,
                       strides, box, CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0ull;
}

struct Maps {
  CUtensorMap w1a, w1b, w1c, w2, out, xs, xt, e;
  int a_by_tma;   // bit seg: operand seg has a map (else it is gathered)
};

template <int BH>
cudaError_t launch_wgmma_tile(const void* xs, const void* xt, const void* e,
                              const float* b1, const float* b2, float* out,
                              const Maps& maps, long long n_rows, int d,
                              int de, int h, int dout, int nodes,
                              int sm_count, cudaStream_t s) {
  static const cudaError_t configured = cudaFuncSetAttribute(
      pair_mlp_wgmma_kernel<BH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Ring<BH>::kSmemBytes);
  if (configured != cudaSuccess) return configured;
  const long long row_tiles = (n_rows + WROWS - 1) / WROWS;
  const int h_tiles = (h + BH - 1) / BH;
  if (row_tiles * h_tiles > 2147483647LL) return cudaErrorInvalidValue;
  // Raster.  A grid deeper than one wave runs with the hidden tile as the
  // fast index: the blocks resident together then share their A rows and
  // add into the same few row tiles of `out` while those are in the L2
  // cache (at E = 16384, `out` is 134 MB against 50 MB of L2).  A grid
  // that fits one wave is resident as a whole either way, and measures
  // faster with the row tile fast (neighbours share a weight tile).
  const int rows_fast = PAIR_RASTER_ROWS_FAST >= 0
                            ? PAIR_RASTER_ROWS_FAST
                            : row_tiles * h_tiles <= sm_count;
  pair_mlp_wgmma_kernel<BH>
      <<<static_cast<unsigned>(row_tiles * h_tiles), WTHREADS,
         Ring<BH>::kSmemBytes, s>>>(
          static_cast<const bf16_bits*>(xs), static_cast<const bf16_bits*>(xt),
          static_cast<const bf16_bits*>(e), b1, b2, out, maps.w1a, maps.w1b,
          maps.w1c, maps.w2, maps.out, maps.xs, maps.xt, maps.e,
          maps.a_by_tma, n_rows, d, de, h, dout, nodes, h_tiles, rows_fast);
  return cudaGetLastError();
}

// The wgmma route.  The tensor maps hold pointers, so they are encoded
// here, on the host, in every call.  The hidden tile is 256 columns wide
// (half as many partial sums to add into `out`) when that still gives
// every SM a block, else 128.
cudaError_t launch_wgmma(const void* xs, const void* xt, const void* e,
                         const void* w1a, const void* w1b, const void* w1c,
                         const float* b1, const void* w2, const float* b2,
                         float* out, long long n_rows, int d, int de, int h,
                         int dout, int nodes, cudaStream_t s) {
  if (d % 8 || de % 8 || h % 8 || dout % 8 || n_rows > 2147483647LL)
    return cudaErrorInvalidValue;
  for (const void* p : {xs, xt, e, w1a, w1b, w1c,
                        static_cast<const void*>(b1), w2,
                        static_cast<const void*>(b2),
                        static_cast<const void*>(out)})
    if (!aligned16(p)) return cudaErrorMisalignedAddress;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapL2promotion wide = CU_TENSOR_MAP_L2_PROMOTION_L2_256B;
  Maps maps;
  const bool ok =
      encode_map(&maps.w1a, bf16, 2, w1a, d, h, 64, 64, wide) &&
      encode_map(&maps.w1b, bf16, 2, w1b != nullptr ? w1b : w1a, d, h, 64,
                 64, wide) &&
      encode_map(&maps.w1c, bf16, 2, w1c, de, h, 64, 64, wide) &&
      encode_map(&maps.w2, bf16, 2, w2, h, dout, 64, 64, wide) &&
      encode_map(&maps.out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, n_rows,
                 dout, 64, 32, CU_TENSOR_MAP_L2_PROMOTION_NONE);
  if (!ok) return cudaErrorUnknown;
  // an operand without a map of its own is gathered; its kernel argument
  // is then a copy of another map that nobody reads
  maps.a_by_tma = 0;
  const void* operands[3] = {xs, xt, e};
  CUtensorMap* operand_maps[3] = {&maps.xs, &maps.xt, &maps.e};
  for (int seg = 0; seg < 3; ++seg) {
    if (encode_operand_map(operand_maps[seg], seg, operands[seg], n_rows,
                           seg == 2 ? de : d, nodes))
      maps.a_by_tma |= 1 << seg;
    else
      *operand_maps[seg] = maps.w1a;
  }
  cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(n_rows) * dout * sizeof(float), s);
  if (err != cudaSuccess) return err;
  static const int sm_count = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const long long row_tiles = (n_rows + WROWS - 1) / WROWS;
  const bool wide_tile = PAIR_FORCE_BH
                             ? PAIR_FORCE_BH == 256
                             : row_tiles * ((h + 255) / 256) >= sm_count;
  if (wide_tile)
    return launch_wgmma_tile<256>(xs, xt, e, b1, b2, out, maps, n_rows, d, de,
                                  h, dout, nodes, sm_count, s);
  return launch_wgmma_tile<128>(xs, xt, e, b1, b2, out, maps, n_rows, d, de,
                                h, dout, nodes, sm_count, s);
}

}  // namespace

extern "C" {

// route: 0 = float32 operands on FMAs, 1 = bfloat16 operands on mma.sync,
// 2 = bfloat16 operands on wgmma (widths multiples of 8, pointers 16-byte
// aligned; refused otherwise).  xs, xt, e, w1*, w2 have the route's
// operand type; b1, b2 and out are float32.  xt and w1b may be null
// together (no target-node operand).  nodes: 0, or N when xs/xt are one
// [B*N, D] node table indexed by pair (see the note at the top).
// Launches on `stream`, does not synchronise, allocates nothing.  Returns
// a cudaError_t.
int pair_mlp_forward(const void* xs, const void* xt, const void* e,
                     const void* w1a, const void* w1b, const void* w1c,
                     const void* b1, const void* w2, const void* b2,
                     void* out, long long n_rows, int d, int de, int h,
                     int dout, int nodes, int route, void* stream) {
  if (n_rows < 0 || d < 1 || de < 1 || h < 1 || dout < 1 || nodes < 0)
    return cudaErrorInvalidValue;
  if ((xt == nullptr) != (w1b == nullptr)) return cudaErrorInvalidValue;
  if (n_rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  float* fout = static_cast<float*>(out);
  cudaError_t err;
  if (route == 0) {
    err = launch<float>(xs, xt, e, w1a, w1b, w1c, fb1, w2, fb2, fout,
                        n_rows, d, de, h, dout, nodes, s);
  } else if (route == 1) {
    err = launch<__nv_bfloat16>(xs, xt, e, w1a, w1b, w1c, fb1, w2, fb2,
                                fout, n_rows, d, de, h, dout, nodes, s);
  } else if (route == 2) {
    err = launch_wgmma(xs, xt, e, w1a, w1b, w1c, fb1, w2, fb2, fout, n_rows,
                       d, de, h, dout, nodes, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* pair_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
