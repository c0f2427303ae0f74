// Fused pair MLP for Hopper (sm_90a):
//
//     out = relu(xs @ W1a + xt @ W1b + e @ W1c + b1) @ W2 + b2
//
// over E rows (flattened node pairs), float32 [E, Dout] out.  Replaces the
// Pallas TPU kernel relpose_gnn_tpu/ops/gnn_pallas.py::_kernel (reached
// through fused_pair_mlp and pair_mlp_apply).  Like it, this kernel keeps
// two tensors out of device memory: the [E, 2D + De] concatenated input
// (the first product is three partial products against slices of W1) and
// the [E, H] hidden activation (each hidden tile lives in shared memory
// between the two products, rounded to the operand type as the TPU kernel
// rounds it before its second product).
//
// What bounds it: operations.  At the bench shape (E = 1024, all widths
// 2048, bf16) the function needs 34 GFLOP against 55 MB of inputs and
// output, far above the card's ridge.
//
// Who owns the accumulator.  The TPU kernel revisits a VMEM-resident
// [block_e, Dout] float32 output block along a sequential hidden axis.
// Here blocks run in no order and that block does not fit an SM (64 rows
// x 2048 columns x 4 B = 512 KB), so the hidden axis is split ACROSS
// blocks: block (i, j) owns row tile i and hidden tile j, computes its
// [BM, BH] hidden tile once (no recomputation), and adds its partial
// [BM, Dout] product into `out` with float32 atomics.  `out` is zeroed
// first and the blocks of hidden tile 0 add b2.  The price: when H spans
// more than one hidden tile the order of the float32 sum over hidden tiles
// changes from run to run, so results agree to float32 rounding of that
// sum (about 1e-7 relative per tile), not bit for bit.
//
// Two kernels share that design.  float32 operands: both products are
// register-tiled FMA loops over shared-memory tiles (4 x 4 outputs a
// thread, 256 threads, 64 x 64 tiles, K step 16), full float32.  bfloat16
// operands: both products run on the tensor cores (mma.sync m16n8k16,
// bf16 in, float32 accumulate; 8 warps as 2 x 4 over a 64 x 128 tile, K
// step 32, fragments fetched with ldmatrix from padded, conflict-free
// shared-memory rows); the hidden tile is written to shared memory as
// bfloat16, which IS the rounding the TPU kernel applies, and read back
// as the A operand of the second product.  Tiles are double-buffered:
// cp.async copies of the next K step are in flight while the tensor cores
// work on this one (ragged edges fall back to masked plain stores).  A
// deeper TMA ring and wgmma are the next step.
//
// Ragged shapes: every load and store is masked on E, D, De, H and Dout;
// no operand is padded.  Rows: with nodes == 0, xs, xt and e are [E, .]
// and row p reads row p of each.  With nodes == N > 0, xs and xt point at
// the same [B * N, D] node table and pair p = (b * N + s) * N + t reads
// xs row p / N and xt row (p / N^2) * N + p % N, so the [E, D] broadcast
// copies are never materialised.  xt == nullptr skips the second partial
// product (the 'msg' form, which has no target-node operand).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// Zeroes `out`, then launches the kernel for the operand type.
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

}  // namespace

extern "C" {

// dtype: 0 = float32 operands, 1 = bfloat16 operands (xs, xt, e, w1*, w2);
// b1, b2 and out are float32.  xt and w1b may be null together (no
// target-node operand).  nodes: 0, or N when xs/xt are one [B*N, D] node
// table indexed by pair (see the note at the top).  Launches on `stream`,
// does not synchronise, allocates nothing.  Returns a cudaError_t.
int pair_mlp_forward(const void* xs, const void* xt, const void* e,
                     const void* w1a, const void* w1b, const void* w1c,
                     const void* b1, const void* w2, const void* b2,
                     void* out, long long n_rows, int d, int de, int h,
                     int dout, int nodes, int dtype, void* stream) {
  if (n_rows < 0 || d < 1 || de < 1 || h < 1 || dout < 1 || nodes < 0)
    return cudaErrorInvalidValue;
  if ((xt == nullptr) != (w1b == nullptr)) return cudaErrorInvalidValue;
  if (n_rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  float* fout = static_cast<float*>(out);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(xs, xt, e, w1a, w1b, w1c, fb1, w2, fb2, fout,
                        n_rows, d, de, h, dout, nodes, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(xs, xt, e, w1a, w1b, w1c, fb1, w2, fb2,
                                fout, n_rows, d, de, h, dout, nodes, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* pair_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
