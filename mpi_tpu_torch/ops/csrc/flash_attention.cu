// Flash attention for Hopper (sm_90a): the forward kernel and the two
// FlashAttention-2 backward kernels, in the JAX package's public layouts:
// q, out, dout, dq (b, s, h, d); k, v, dk, dv (b, t, hk, d) with h % hk == 0
// (GQA reads kv head h_i / (h / hk), never a repeated copy); lse and delta
// (b, h, s) float32. All tensors contiguous and 16-byte aligned; d is 64 or
// 128; one element type, float32 or bfloat16, for every q/k/v-like tensor.
//
// Arithmetic contract (the TPU kernels'): logits = (q . k) * scale from the
// stored dtype with float32 accumulation; the mask is col < t and, when
// causal, row >= col, aligned at the top left; the softmax state is float32;
// p (and ds) are rounded to the operand dtype before the products they feed;
// outputs are written once, in the dtype of their input.
//
// Kernel 1 replaces mpi_tpu/ops/attention.py: _flash_kernel_fwd_res; kernel
// 2, flash_bwd_dq_kernel (float32) and flash_bwd_dq_wgmma_kernel (bf16),
// replaces _flash_bwd_dq_kernel; kernel 3, flash_bwd_dkv_kernel and
// flash_bwd_dkv_wgmma_kernel, replaces _flash_bwd_dkv_kernel. The TPU
// kernels walk one reduction axis as a sequential grid axis with VMEM
// scratch; here one thread block owns one output tile and walks that axis
// in a loop, with its state in registers.
//
// Kernel 1 in bf16 (flash_fwd_wgmma_kernel) is built for Hopper's tensor
// cores. At the flagship training shape (b 8, s = t 1024, h 8, d 128,
// causal) it must read q, k and v and write out and lse, 67.4 MB, 20.1 us
// at 3.35 TB/s, and do two products of 8.6 GFLOP over the pairs the mask
// keeps, 17.4 us at 989 TFLOP/s: both bounds are near, so the tensor cores
// must run near their rate while the loads stay hidden. The design:
//   * one block per 128 query rows of one (b, h): two consumer warpgroups of
//     64 rows each and one producer warp, whose first thread issues every
//     load. ptxas allocates a wgmma kernel's registers by whole warpgroups,
//     so 288 threads, like 384, leave each thread 168 (setmaxnreg does not
//     change that); the kernel takes 166.
//   * TMA (cp.async.bulk.tensor, 4-d tensor maps over the (b, s, h, d)
//     layouts, made with cuTensorMapEncodeTiled through the runtime's
//     driver entry point) loads Q once and K/V tiles of 128 keys into a
//     two-stage ring, with full and empty mbarriers per stage and per
//     operand; the 128-byte swizzle limits a box to 64 columns, so d = 128
//     is two boxes; TMA's zero fill covers the ragged edge of s and t;
//   * S = Q K^T is wgmma m64n128k16 with both operands in shared memory,
//     K-major, 128-byte swizzled; O += P V is wgmma m64n{d}k16 with P in
//     registers (the float32 S accumulator converted in place to the bf16
//     A fragment: no shared-memory round trip) and V, MN-major, read through
//     the instruction's transpose bit;
//   * the two warpgroups take turns to issue their products (named
//     barriers), so one's softmax runs while the other's products do;
//   * the softmax state stays in registers; ex2.approx with scale * log2(e)
//     folded into one FMA; the causal and ragged mask is applied only on
//     tiles that cross the diagonal or the edge; tiles past the diagonal are
//     skipped; key tiles run last first (the masked ones come first), and
//     blocks run heaviest query tile first across all (b, h).
// What holds it back at the flagship shape: a block runs 1 to 8 key tiles,
// so every block's fill (Q and its first K/V from memory) and drain (out)
// are exposed; at long context, where a block runs many tiles, the same
// kernel is near its compute bound (chip_smoke.py times both). Not done
// yet: a persistent grid that overlaps one tile's drain with the next
// one's fill; overlap of a tile's softmax with the next tile's products
// inside a warpgroup (with 128-key tiles ptxas then serializes the wgmmas
// and spills, C7512; with 64-key tiles it fits but ran no faster); a TMA
// store of out.
//
// Kernels 2 and 3 in bf16 (flash_bwd_dq_wgmma_kernel and
// flash_bwd_dkv_wgmma_kernel) do 3 and 4 such products at the flagship
// shape (26.1 and 34.8 us at the tensor peak) and move 101 MB each (30.2
// us; kernel 2 also reads out and writes delta), so bytes bound kernel 2
// and operations kernel 3, both near the line. They keep kernel 1's TMA
// loads into an mbarrier ring, its two consumer warpgroups of 64 rows that
// take turns to issue their products, and its way of turning each float32
// accumulator (p, ds and their transposes) into the bf16 A fragment of the
// next product in registers. ptxas allocates a wgmma kernel's registers by
// whole warpgroups, so kernel 1's producer warp (288 threads) leaves each
// thread 168, setmaxnreg notwithstanding (a producer warpgroup, 384
// threads, gave the same). Kernel 2 fits that, and keeps kernel 1's block
// with a two-stage ring. Kernel 3 holds dk and dv (128 registers) beside
// S^T and dP^T (64) and spilled in it; its block is the two warpgroups
// alone (256 threads, up to 255 registers), whose warp 0 also issues the
// loads: each query tile two ahead, into a three-stage ring, once both
// warpgroups have released the stage.
//   * kernel 2 (dq): one block per 128 query rows of one (b, h); Q, dO and
//     out are loaded once, K/V tiles of 64 keys stream, the causal walk
//     stops at the diagonal. S = Q K^T and dP = dO V^T are SS wgmma,
//     K-major; ds = p (dP - delta) scale goes to registers and dq += ds K
//     is RS wgmma with K MN-major through the transpose bit. Before its
//     first tile each warpgroup takes delta = rowsum(dO * O) of its rows
//     from shared memory, keeps it in registers and writes it for kernel 3.
//     Given out == nullptr it instead reads delta from memory: that is the
//     TPU kernel's interface (dq from q, k, v, dout, lse and delta), kept
//     so flash_bwd_dq can be held against it alone.
//   * kernel 3 (dk, dv): one block per 128 keys of one (b, hk), 64 keys
//     per warpgroup; K and V are loaded once, query tiles of 64 of every
//     head of the kv head's group stream (member-major), the causal walk
//     starts at the first tile that reaches the block. S^T = K Q^T and
//     dP^T = V dO^T are SS; p^T and ds^T go to registers; dv += p^T dO and
//     dk += ds^T Q are RS with dO and Q MN-major. Each tile's lse and delta
//     come beside it by cp.async from warp 0 (a (b h, s) float32 row is
//     16-byte aligned only when s % 4 == 0, which TMA needs). dk, dv: 64
//     registers each; the kernel takes 254 at d = 128.
//   * a warpgroup's tiles that the causal mask hides entirely (warpgroup
//     0's last key tile in kernel 2, warpgroup 1's first query tile of each
//     head in kernel 3) take their turns and issue nothing, in a loop of
//     their own: a product under a branch serialises every wgmma of the
//     kernel (ptxas C7518).
// Both write each output once, with no atomics. What still holds them
// back: as in kernel 1, a block runs few tiles at the flagship shape, so
// its fill and drain weigh; a warpgroup's elementwise step waits for its
// own products (only the other warpgroup's products overlap it); and the
// two kernels recompute p, so together they issue 7 products where one
// fused backward with dq by atomics would issue 5.
//
// Kernel 1 in float32, and kernels 2 and 3 in float32, use FMAs (they
// exist for exact checks and are slow) in one layout: each warp owns 16
// rows of the output tile in the accumulator layout of mma.sync m16n8,
// the 4 warps of a block share each tile staged in shared memory by
// double-buffered cp.async, rows padded by 16 bytes, and p or ds goes
// through a small per-warp shared tile between the two products. Kernel 2
// in float32 also computes delta, from out and dout in memory. Causal tiles
// past the diagonal are skipped per block and per warp, and the ragged
// edge is zero-filled on load and masked, so no shape needs padding
// outside the kernels.

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached
                   // through cudaGetDriverEntryPoint, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The float32 kernels' tiles.
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = kWarps * 16;  // query rows (kernels 1, 2) or keys (3)
constexpr int kFwdBlockN = 64;        // keys per tile, kernel 1
constexpr int kDqBlockN = 32;         // keys per tile, kernel 2
constexpr int kDkvBlockQ = 32;        // queries per tile, kernel 3
constexpr float kNegInf = -1e30f;

// Elements in 16 bytes: one cp.async, and the padding of a shared row.
template <typename T>
__host__ __device__ constexpr int vec() { return 16 / static_cast<int>(sizeof(T)); }

// Two neighbouring float32 elements.
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// ---- cp.async ---------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = fill ? 16 : 0;  // 0 source bytes: the 16 bytes become zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows row0 .. row0 + ROWS - 1 of a (n_rows x D) slice, whose row r
// starts at src + r * stride, into shared rows of D + vec<T>() elements.
// Rows at or past n_rows are zero-filled.
template <typename T, int ROWS, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, size_t stride,
                                          int row0, int n_rows) {
  constexpr int V = vec<T>();
  constexpr int kChunks = D / V;  // 16-byte pieces per row
  constexpr int LD = D + V;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * V;
    const int row = row0 + r;
    const bool ok = row < n_rows;
    cp_async16(dst + r * LD + c, src + static_cast<size_t>(ok ? row : 0) *
                                           stride + c, ok);
  }
}

// ---- warp-level products (float32) -------------------------------------
//
// c[j] += A (16 x K) * B (K x 8 NT) for one warp, in the accumulator layout
// of mma.sync m16n8: lane (g = lane / 4, q = lane % 4) holds c[j][0..1] at
// row g, columns 8 j + 2 q + {0, 1}, and c[j][2..3] at row g + 8. A is
// row-major in shared memory (lda elements a row). B is row-major [k][n]
// when BT is false, or given as its transpose [n][k] when BT is true.

template <bool BT, int NT, int K>
__device__ __forceinline__ void warp_gemm(float (&c)[NT][4], const float* a,
                                          int lda, const float* b, int ldb,
                                          int g, int q) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = a[g * lda + k];
    const float a1 = a[(g + 8) * lda + k];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = 8 * j + 2 * q;
      const float b0 = BT ? b[n * ldb + k] : b[k * ldb + n];
      const float b1 = BT ? b[(n + 1) * ldb + k] : b[k * ldb + n + 1];
      c[j][0] = fmaf(a0, b0, c[j][0]);
      c[j][1] = fmaf(a0, b1, c[j][1]);
      c[j][2] = fmaf(a1, b0, c[j][2]);
      c[j][3] = fmaf(a1, b1, c[j][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// Write a warp's 16 x 8 NT accumulator tile into shared rows of ld
// elements.
template <int NT>
__device__ __forceinline__ void stash(float* dst, int ld,
                                      const float (&c)[NT][4], int g, int q) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    store_pair(dst + g * ld + 8 * j + 2 * q, c[j][0], c[j][1]);
    store_pair(dst + (g + 8) * ld + 8 * j + 2 * q, c[j][2], c[j][3]);
  }
}

// Blocks in reverse order of their query tile: under a causal mask the last
// tiles carry the most work, so they start first.
__device__ __forceinline__ int reversed_tile() {
  return gridDim.x - 1 - blockIdx.x;
}

// ---- kernel 1, float32: forward -------------------------------------------
//
// One block per (query tile of 64 rows, b * h). Loops over key tiles of 64,
// stopping at the diagonal when causal; m, l and the output accumulator
// stay in registers (float32) and out and lse are written once. (bf16 takes
// flash_fwd_wgmma_kernel below.)

template <int D>
__device__ __forceinline__ void
flash_fwd_tile(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ out,
               float* __restrict__ lse, int s, int t, int h, int hk,
               int causal, float scale, int bh) {
  using T = float;
  constexpr int BM = kBlockM, BN = kFwdBlockN;
  constexpr int LD = D + vec<T>(), LDP = BN + vec<T>();
  constexpr int NS = BN / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BM * LD;      // two buffers
  T* sV = sK + 2 * BN * LD;  // two buffers
  T* sP = sV + 2 * BN * LD;  // one 16 x BN tile per warp

  const int m0 = reversed_tile() * BM;
  const int bi = bh / h, hi = bh % h, kvh = hi / (h / hk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  const int row_w = m0 + warp * 16;  // first query row of this warp

  const size_t q_stride = static_cast<size_t>(h) * D;
  const size_t kv_stride = static_cast<size_t>(hk) * D;
  const T* qb = q + (static_cast<size_t>(bi) * s * h + hi) * D;
  const T* kb = k + (static_cast<size_t>(bi) * t * hk + kvh) * D;
  const T* vb = v + (static_cast<size_t>(bi) * t * hk + kvh) * D;

  int n_tiles = (t + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (m0 + BM - 1) / BN + 1);

  load_tile<T, BM, D>(sQ, qb, q_stride, m0, s);
  load_tile<T, BN, D>(sK, kb, kv_stride, 0, t);
  load_tile<T, BN, D>(sV, vb, kv_stride, 0, t);
  cp_async_commit();

  float o[NO][4];
  zero(o);
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};  // this lane's share of each row's sum
  const T* sQw = sQ + warp * 16 * LD;
  T* sPw = sP + warp * 16 * LDP;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<T, BN, D>(sK + (buf ^ 1) * BN * LD, kb, kv_stride,
                          (j + 1) * BN, t);
      load_tile<T, BN, D>(sV + (buf ^ 1) * BN * LD, vb, kv_stride,
                          (j + 1) * BN, t);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int n0 = j * BN;
    if (!causal || n0 <= row_w + 15) {  // warp-uniform
      float sc[NS][4];
      zero(sc);
      warp_gemm<true, NS, D>(sc, sQw, LD, sK + buf * BN * LD, LD, g, qd);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int jj = 0; jj < NS; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row_w + g + (e >> 1) * 8;
          const int col = n0 + 8 * jj + 2 * qd + (e & 1);
          const bool ok = col < t && (!causal || row >= col);
          sc[jj][e] = ok ? sc[jj][e] * scale : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[jj][e]);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);
        corr[r] = expf(m_r[r] - m_new);
        m_r[r] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int jj = 0; jj < NS; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row_w + g + (e >> 1) * 8;
          const int col = n0 + 8 * jj + 2 * qd + (e & 1);
          const bool ok = col < t && (!causal || row >= col);
          const float p = ok ? expf(sc[jj][e] - m_r[e >> 1]) : 0.f;
          sc[jj][e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + sum[r];
#pragma unroll
      for (int jj = 0; jj < NO; ++jj) {
        o[jj][0] *= corr[0];
        o[jj][1] *= corr[0];
        o[jj][2] *= corr[1];
        o[jj][3] *= corr[1];
      }
      stash<NS>(sPw, LDP, sc, g, qd);
      __syncwarp();
      warp_gemm<false, NO, BN>(o, sPw, LDP, sV + buf * BN * LD, LD, g, qd);
      __syncwarp();
    }
    __syncthreads();  // the buffers are refilled by the next iteration
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int row = row_w + g + 8 * r;
    if (row < s) {
      T* orow = out + ((static_cast<size_t>(bi) * s + row) * h + hi) * D;
      const float inv = 1.f / l;
#pragma unroll
      for (int jj = 0; jj < NO; ++jj)
        store_pair(orow + 8 * jj + 2 * qd, o[jj][2 * r] * inv,
                   o[jj][2 * r + 1] * inv);
      if (qd == 0) lse[static_cast<size_t>(bh) * s + row] = m_r[r] + logf(l);
    }
  }
}

// ---- delta = rowsum(dout * out) ----------------------------------------

// Sum of o[i] * g[i] for i < N, from 16-byte loads.
template <int N>
__device__ __forceinline__ float dot(const float* o, const float* g) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < N; c += 4) {
    const float4 a = *reinterpret_cast<const float4*>(o + c);
    const float4 b = *reinterpret_cast<const float4*>(g + c);
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    acc = fmaf(a.w, b.w, acc);
  }
  return acc;
}
template <int N>
__device__ __forceinline__ float dot(const __nv_bfloat16* o,
                                     const __nv_bfloat16* g) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < N; c += 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + c);
    const uint4 b = *reinterpret_cast<const uint4*>(g + c);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(a2[i]);
      const float2 y = __bfloat1622float2(b2[i]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
  return acc;
}

// delta = rowsum(dout * out) in float32 for the 64 rows row0 .. row0 + 63
// of (b, h) row bh, by 128 threads (tid), two to a row: into sm[0 .. 63]
// (0 past s) and, for rows < s, delta_out. The caller synchronises the 128
// threads before it reads sm.
template <int D>
__device__ __forceinline__ void rows_delta(const float* __restrict__ out,
                                           const float* __restrict__ dout,
                                           float* __restrict__ delta_out,
                                           float* sm, int tid, int row0,
                                           int s, int h, int bh) {
  const int r = tid / 2, half = tid % 2, row = row0 + r;
  float acc = 0.f;
  if (row < s) {
    const size_t off =
        ((static_cast<size_t>(bh / h) * s + row) * h + bh % h) * D +
        half * (D / 2);
    acc = dot<D / 2>(out + off, dout + off);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (half == 0) {
    sm[r] = acc;
    if (row < s) delta_out[static_cast<size_t>(bh) * s + row] = acc;
  }
}

// ---- kernel 2, float32: dq ------------------------------------------------
//
// One block per (query tile of 64 rows, b * h). Loops over key tiles of 32
// up to the diagonal; p = exp(q k * scale - lse), ds = p (dp - delta) scale,
// dq += ds K accumulates in float32 registers and is written once. With
// `out` given, the block first computes delta for its rows from out and
// dout and writes it to delta_out; else it reads `delta`. (bf16 takes
// flash_bwd_dq_wgmma_kernel below.)

template <int D>
__device__ __forceinline__ void
flash_bwd_dq_tile(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const float* __restrict__ out,
                  float* __restrict__ delta_out, float* __restrict__ dq,
                  int s, int t, int h, int hk, int causal, float scale,
                  int bh) {
  using T = float;
  constexpr int BM = kBlockM, BN = kDqBlockN;
  constexpr int LD = D + vec<T>(), LDP = BN + vec<T>();
  constexpr int NS = BN / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sO = sQ + BM * LD;      // dout rows
  T* sK = sO + BM * LD;      // two buffers
  T* sV = sK + 2 * BN * LD;  // two buffers
  T* sS = sV + 2 * BN * LD;  // one 16 x BN ds tile per warp
  float* sD = sS + kWarps * 16 * LDP;  // delta of the BM rows

  const int m0 = reversed_tile() * BM;
  const int bi = bh / h, hi = bh % h, kvh = hi / (h / hk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  const int row_w = m0 + warp * 16;

  const size_t q_stride = static_cast<size_t>(h) * D;
  const size_t kv_stride = static_cast<size_t>(hk) * D;
  const size_t q_off = (static_cast<size_t>(bi) * s * h + hi) * D;
  const T* kb = k + (static_cast<size_t>(bi) * t * hk + kvh) * D;
  const T* vb = v + (static_cast<size_t>(bi) * t * hk + kvh) * D;

  int n_tiles = (t + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (m0 + BM - 1) / BN + 1);

  load_tile<T, BM, D>(sQ, q + q_off, q_stride, m0, s);
  load_tile<T, BM, D>(sO, dout + q_off, q_stride, m0, s);
  load_tile<T, BN, D>(sK, kb, kv_stride, 0, t);
  load_tile<T, BN, D>(sV, vb, kv_stride, 0, t);
  cp_async_commit();

  if (out != nullptr) {
    rows_delta<D>(out, dout, delta_out, sD, threadIdx.x, m0, s, h, bh);
    __syncthreads();
  }
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_w + g + 8 * r;
    const size_t i = static_cast<size_t>(bh) * s + row;
    lse_r[r] = row < s ? lse[i] : 0.f;
    delta_r[r] = row >= s ? 0.f : out != nullptr ? sD[row - m0] : delta[i];
  }
  float acc[NO][4];
  zero(acc);
  const T* sQw = sQ + warp * 16 * LD;
  const T* sOw = sO + warp * 16 * LD;
  T* sSw = sS + warp * 16 * LDP;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<T, BN, D>(sK + (buf ^ 1) * BN * LD, kb, kv_stride,
                          (j + 1) * BN, t);
      load_tile<T, BN, D>(sV + (buf ^ 1) * BN * LD, vb, kv_stride,
                          (j + 1) * BN, t);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int n0 = j * BN;
    if (!causal || n0 <= row_w + 15) {
      const T* sKj = sK + buf * BN * LD;
      float sc[NS][4], dp[NS][4];
      zero(sc);
      zero(dp);
      warp_gemm<true, NS, D>(sc, sQw, LD, sKj, LD, g, qd);
      warp_gemm<true, NS, D>(dp, sOw, LD, sV + buf * BN * LD, LD, g, qd);
#pragma unroll
      for (int jj = 0; jj < NS; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int row = row_w + g + 8 * r;
          const int col = n0 + 8 * jj + 2 * qd + (e & 1);
          const bool ok = col < t && (!causal || row >= col);
          const float p = ok ? expf(sc[jj][e] * scale - lse_r[r]) : 0.f;
          sc[jj][e] = p * (dp[jj][e] - delta_r[r]) * scale;
        }
      stash<NS>(sSw, LDP, sc, g, qd);
      __syncwarp();
      warp_gemm<false, NO, BN>(acc, sSw, LDP, sKj, LD, g, qd);
      __syncwarp();
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_w + g + 8 * r;
    if (row < s) {
      T* drow = dq + ((static_cast<size_t>(bi) * s + row) * h + hi) * D;
#pragma unroll
      for (int jj = 0; jj < NO; ++jj)
        store_pair(drow + 8 * jj + 2 * qd, acc[jj][2 * r],
                   acc[jj][2 * r + 1]);
    }
  }
}

// ---- kernel 3, float32: dk, dv -------------------------------------------
//
// One block per (key tile of 64, b * hk). Loops over the group's query heads
// and, for each, over query tiles of 32 from the first one that reaches the
// key tile when causal. Works on the transposed products (keys as rows):
// p^T = exp(k q * scale - lse), dv += p^T dO, ds^T = p^T (dp^T - delta)
// scale, dk += ds^T Q. dk and dv accumulate in float32 registers and are
// written once per kv head: no atomics. (bf16 takes
// flash_bwd_dkv_wgmma_kernel below.)

template <int D>
__device__ __forceinline__ void
flash_bwd_dkv_tile(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int s, int t, int h, int hk,
                   int causal, float scale, int bkv) {
  using T = float;
  constexpr int BK = kBlockM, BQ = kDkvBlockQ;
  constexpr int LD = D + vec<T>(), LDP = BQ + vec<T>();
  constexpr int NS = BQ / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + BK * LD;
  T* sQ = sV + BK * LD;      // two buffers
  T* sO = sQ + 2 * BQ * LD;  // dout rows, two buffers
  T* sP = sO + 2 * BQ * LD;  // one 16 x BQ tile per warp

  const int n0 = blockIdx.x * BK;
  const int bi = bkv / hk, kvh = bkv % hk, group = h / hk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;
  const int key_w = n0 + warp * 16;  // first key of this warp

  const size_t q_stride = static_cast<size_t>(h) * D;
  const size_t kv_stride = static_cast<size_t>(hk) * D;
  const size_t kv_off = (static_cast<size_t>(bi) * t * hk + kvh) * D;

  // Query rows before n0 see none of these keys under the causal mask.
  const int q_start = causal ? (n0 / BQ) * BQ : 0;
  const int n_qt = q_start < s ? (s - q_start + BQ - 1) / BQ : 0;
  const int n_it = group * n_qt;  // (group member, query tile), member-major

  auto q_off = [&](int it) {
    const int head = kvh * group + it / n_qt;
    return (static_cast<size_t>(bi) * s * h + head) * D;
  };
  auto q_row0 = [&](int it) { return q_start + (it % n_qt) * BQ; };

  load_tile<T, BK, D>(sK, k + kv_off, kv_stride, n0, t);
  load_tile<T, BK, D>(sV, v + kv_off, kv_stride, n0, t);
  if (n_it > 0) {
    load_tile<T, BQ, D>(sQ, q + q_off(0), q_stride, q_row0(0), s);
    load_tile<T, BQ, D>(sO, dout + q_off(0), q_stride, q_row0(0), s);
  }
  cp_async_commit();

  float dk_acc[NO][4], dv_acc[NO][4];
  zero(dk_acc);
  zero(dv_acc);
  const T* sKw = sK + warp * 16 * LD;
  const T* sVw = sV + warp * 16 * LD;
  T* sPw = sP + warp * 16 * LDP;

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) {
      load_tile<T, BQ, D>(sQ + (buf ^ 1) * BQ * LD, q + q_off(it + 1),
                          q_stride, q_row0(it + 1), s);
      load_tile<T, BQ, D>(sO + (buf ^ 1) * BQ * LD, dout + q_off(it + 1),
                          q_stride, q_row0(it + 1), s);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = q_row0(it);
    if (!causal || q0 + BQ - 1 >= key_w) {  // warp-uniform
      const int bhq = bi * h + kvh * group + it / n_qt;
      const T* sQi = sQ + buf * BQ * LD;
      const T* sOi = sO + buf * BQ * LD;
      // lse and delta of this lane's query columns.
      float lq[NS][2], dlt[NS][2];
#pragma unroll
      for (int jj = 0; jj < NS; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = q0 + 8 * jj + 2 * qd + c;
          const size_t i = static_cast<size_t>(bhq) * s + col;
          lq[jj][c] = col < s ? lse[i] : 0.f;
          dlt[jj][c] = col < s ? delta[i] : 0.f;
        }
      float sc[NS][4], dp[NS][4];
      zero(sc);
      zero(dp);
      warp_gemm<true, NS, D>(sc, sKw, LD, sQi, LD, g, qd);
#pragma unroll
      for (int jj = 0; jj < NS; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_w + g + (e >> 1) * 8;
          const int col = q0 + 8 * jj + 2 * qd + (e & 1);
          const bool ok = key < t && col < s && (!causal || col >= key);
          sc[jj][e] = ok ? expf(sc[jj][e] * scale - lq[jj][e & 1]) : 0.f;
        }
      stash<NS>(sPw, LDP, sc, g, qd);
      __syncwarp();
      warp_gemm<false, NO, BQ>(dv_acc, sPw, LDP, sOi, LD, g, qd);
      warp_gemm<true, NS, D>(dp, sVw, LD, sOi, LD, g, qd);
#pragma unroll
      for (int jj = 0; jj < NS; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[jj][e] = sc[jj][e] * (dp[jj][e] - dlt[jj][e & 1]) * scale;
      __syncwarp();  // every lane has read p^T
      stash<NS>(sPw, LDP, sc, g, qd);
      __syncwarp();
      warp_gemm<false, NO, BQ>(dk_acc, sPw, LDP, sQi, LD, g, qd);
      __syncwarp();
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_w + g + 8 * r;
    if (key < t) {
      const size_t off = ((static_cast<size_t>(bi) * t + key) * hk + kvh) * D;
#pragma unroll
      for (int jj = 0; jj < NO; ++jj) {
        store_pair(dk + off + 8 * jj + 2 * qd, dk_acc[jj][2 * r],
                   dk_acc[jj][2 * r + 1]);
        store_pair(dv + off + 8 * jj + 2 * qd, dv_acc[jj][2 * r],
                   dv_acc[jj][2 * r + 1]);
      }
    }
  }
}

// ---- the kernels ----------------------------------------------------------
//
// The (batch, head) rows, b * h (b * hk for kernel 3), run on grid y, which
// stops at 65535 where b * h need not: rows past it go on to grid z, and
// block (x, y, z) takes row y + gridDim.y * z. The blocks of the last z
// layer past the last row return at once. (Looping over rows with stride
// gridDim.y inside one block instead made kernels 1 and 3 9% and 19% slower
// at the flagship training shape on an H100 80GB HBM3 at 700 W: the loop
// changed their register allocation.)

constexpr int kMaxGridY = 65535;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int s, int t, int h, int hk,
                 int causal, float scale, int rows) {
  const int bh = blockIdx.y + gridDim.y * blockIdx.z;
  if (bh < rows) {
    flash_fwd_tile<D>(q, k, v, out, lse, s, t, h, hk, causal, scale, bh);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ out,
                    float* __restrict__ delta_out, float* __restrict__ dq,
                    int s, int t, int h, int hk, int causal, float scale,
                    int rows) {
  const int bh = blockIdx.y + gridDim.y * blockIdx.z;
  if (bh < rows) {
    flash_bwd_dq_tile<D>(q, k, v, dout, lse, delta, out, delta_out, dq, s,
                         t, h, hk, causal, scale, bh);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int s, int t, int h, int hk,
                     int causal, float scale, int rows) {
  const int bkv = blockIdx.y + gridDim.y * blockIdx.z;
  if (bkv < rows) {
    flash_bwd_dkv_tile<D>(q, k, v, dout, lse, delta, dk, dv, s, t, h, hk,
                          causal, scale, bkv);
  }
}

// ---- kernel 1, bf16: wgmma and TMA ----------------------------------------
//
// Shared memory holds Q (128 rows), and K and V tiles of 128 keys in a ring
// of kFwdStages stages. Each tile is d / 64 column blocks of (rows x 64)
// bf16, each block 128-byte swizzled as TMA writes it (16-byte piece c of
// row r at c ^ (r % 8)) and 1024-byte aligned, which is the layout the
// wgmma descriptors name: K-major for Q and K (a 16-deep step of d moves
// the start by 32 bytes inside a block), MN-major for V (a step of 16 keys
// moves it by 16 rows; the next 64 columns of d are the next block).

constexpr int kFwdRows = 128;      // query rows per block
constexpr int kFwdKeys = 128;      // keys per tile
constexpr int kFwdStages = 2;      // K/V ring depth
constexpr int kFwdThreads = 288;   // 2 consumer warpgroups + 1 producer warp
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct FwdSmem {
  __nv_bfloat16 q[kFwdRows * D];
  __nv_bfloat16 k[kFwdStages][kFwdKeys * D];
  __nv_bfloat16 v[kFwdStages][kFwdKeys * D];
  uint64_t q_full;
  uint64_t k_full[kFwdStages], k_empty[kFwdStages];
  uint64_t v_full[kFwdStages], v_empty[kFwdStages];
};

// Dynamic shared memory of a wgmma kernel whose layout is Smem, and that
// layout at the first 1024-byte boundary (as the 128-byte swizzle needs).
template <typename Smem>
constexpr int wgmma_smem() {
  return static_cast<int>(sizeof(Smem)) + 1024;  // + alignment slack
}
template <typename Smem>
__device__ __forceinline__ Smem& aligned_smem() {
  extern __shared__ unsigned char smem_raw[];
  return *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
}

// The launch number of this block (grid x fastest).
__device__ __forceinline__ long long launch_index() {
  return blockIdx.x + static_cast<long long>(gridDim.x) *
                          (blockIdx.y + static_cast<long long>(gridDim.y) *
                                            blockIdx.z);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}
// Wait until the phase of parity `parity` has completed. A wait that has
// not ended after some seconds traps, so a fault in the pipeline ends the
// launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t spin = 0;; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (spin > (1u << 26)) __trap();
  }
}

// One box of a 4-d tensor map (coordinates innermost first) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma

// Descriptor of a 128-byte swizzled operand tile: start address, leading
// and stride byte offsets (in 16-byte units), layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous product that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// d[64] (+)= A . B for m64n128k16: A and B from shared memory, both
// K-major. scale_d 0 ignores d's old value.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64] (+)= A . B for m64n128k16: A from registers (each warp's
// m16k16 bf16 fragment of its 16 rows), B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d[32] (+)= A . B for m64n64k16: A from registers (each warp's
// m16k16 bf16 fragment of its 16 rows), B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d[32] (+)= A . B for m64n64k16: A and B from shared memory, both
// K-major. scale_d 0 ignores d's old value.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 128) {
    wgmma_rs_n128(d, a, b, 1);
  } else {
    wgmma_rs_n64(d, a, b, 1);
  }
}

// 2^x by the hardware's approximation (ex2.approx.ftz: about 2 ulp).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

struct FwdShape {
  int s, t, h, hk, causal, tiles;
  long long rows;  // b * h
  float scale;
};

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
// The 128 threads of one warpgroup.
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}
// A backward warpgroup's two turns of one tile, issuing nothing.
__device__ __forceinline__ void pass_turns(int wg) {
  named_sync(1 + wg);
  named_arrive(2 - wg);
  named_sync(1 + wg);
  named_arrive(2 - wg);
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Issue S = Q K^T for this warpgroup's 64 rows. q_desc and k_desc describe
// the first column block of this warpgroup's Q rows and of a K stage; a
// 16-deep step of d moves 32 bytes (2 units of 16) inside a block, and the
// next block of 64 columns lies rows x 128 bytes on.
template <int D>
__device__ __forceinline__ void issue_s(float (&sc)[64], uint64_t q_desc,
                                        uint64_t k_desc) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int blk = kk / 4, step = (kk % 4) * 2;
    wgmma_ss_n128(sc, q_desc + blk * (kFwdRows * 128 / 16) + step,
                  k_desc + blk * (kFwdKeys * 128 / 16) + step, kk > 0);
  }
}

// Issue O += P V against the V stage that v_desc describes, over KS steps
// of 16 keys: a step moves 16 rows of 128 bytes. (The backward kernels use
// it for every RS product: dq += ds K, dv += p^T dO, dk += ds^T Q.)
template <int D, int KS = 8>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[KS][4],
                                         uint64_t v_desc) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_pv<D>(o, pa[kk], v_desc + kk * (16 * 128 / 16));
}

// The online softmax of one key tile (keys n0 ..): masks where the tile
// crosses the edge of t or, for this warp's rows, the diagonal; updates the
// running max m_r and this thread's share of the row sums l_r; leaves p =
// exp2(s c - m log2 e) in sc and the factor that rescales O in corr.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], const FwdShape& f,
                                             int n0, int row_w, int g, int qd,
                                             float (&m_r)[2], float (&l_r)[2],
                                             float (&corr)[2]) {
  if (n0 + kFwdKeys > f.t || (f.causal && n0 + kFwdKeys - 1 > row_w)) {
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_w + g + 8 * (e >> 1);
        const int col = n0 + 8 * jj + 2 * qd + (e & 1);
        if (col >= f.t || (f.causal && col > row)) sc[4 * jj + e] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * jj + e]);
  const float c = f.scale * kLog2e;
  float neg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_r[r], mx[r] * f.scale);
    corr[r] = fast_exp2((m_r[r] - m_new) * kLog2e);
    m_r[r] = m_new;
    neg[r] = -m_new * kLog2e;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = fast_exp2(fmaf(sc[4 * jj + e], c, neg[e >> 1]));
      sc[4 * jj + e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + sum[r];
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&corr)[2]) {
#pragma unroll
  for (int jj = 0; jj < N / 4; ++jj) {
    o[4 * jj + 0] *= corr[0];
    o[4 * jj + 1] *= corr[0];
    o[4 * jj + 2] *= corr[1];
    o[4 * jj + 3] *= corr[1];
  }
}

// p, rounded to bf16, as the A fragments of the KS key steps of P V: key
// step kk is S columns 16 kk .. 16 kk + 15, accumulator blocks 2 kk and
// 2 kk + 1.
template <int KS>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[KS][4],
                                       const float (&sc)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// One consumer warpgroup: 64 query rows from row_wg, against key tiles
// n_tiles - 1 .. 0. Thread (warp w, lane: g = lane / 4, qd = lane % 4) holds
// rows row_wg + 16 w + g and + 8 of every accumulator: in S (64 x 128 keys),
// sc[4 j + e] is key 8 j + 2 qd + (e & 1) of row + 8 (e >> 1); in O (64 x
// d), o[4 j + e] column 8 j + 2 qd + (e & 1) likewise.
template <int D>
__device__ __forceinline__ void fwd_consumer(FwdSmem<D>& sm, const FwdShape& f,
                                             __nv_bfloat16* __restrict__ out,
                                             float* __restrict__ lse,
                                             int wg, int m0, int bh,
                                             int n_tiles) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, qd = lane % 4;
  const int row_w = m0 + 64 * wg + 16 * warp;  // this warp's first row

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};  // running max of the scaled logits
  float l_r[2] = {0.f, 0.f};          // this thread's share of each row sum
  float sc[64], corr[2];
  uint32_t pa[8][4];
  // Descriptors of this warpgroup's Q rows and of K and V stage 0; stage st
  // lies st * stage units of 16 bytes on.
  const uint64_t q_desc = wgmma_desc(sm.q + 64 * wg * 64, 16, 1024);
  const uint64_t k_desc = wgmma_desc(sm.k[0], 16, 1024);
  const uint64_t v_desc = wgmma_desc(sm.v[0], kFwdKeys * 128, 1024);
  constexpr int stage = kFwdKeys * D * 2 / 16;

  mbar_wait(&sm.q_full, 0);
  // The two warpgroups take turns to issue their products (named barriers
  // 1 and 2, warpgroup 0 first), so one's softmax runs while the other's
  // products do.
  if (n_tiles > 0 && wg == 0) named_arrive(1);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kFwdStages;
    const uint32_t ph = (it / kFwdStages) & 1;
    mbar_wait(&sm.k_full[st], ph);
    named_sync(1 + wg);
    wgmma_fence();
    issue_s<D>(sc, q_desc, k_desc + st * stage);
    wgmma_commit();
    named_arrive(2 - wg);
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(&sm.k_empty[st]);
    softmax_tile(sc, f, (n_tiles - 1 - it) * kFwdKeys, row_w, g, qd, m_r,
                 l_r, corr);
    rescale(o, corr);
    pack_p(pa, sc);
    mbar_wait(&sm.v_full[st], ph);
    named_sync(1 + wg);
    fence_regs(pa);
    fence_regs(o);
    wgmma_fence();
    issue_pv<D>(o, pa, v_desc + st * stage);
    wgmma_commit();
    named_arrive(2 - wg);
    wgmma_wait<0>();
    fence_regs(pa);
    fence_regs(o);
    mbar_arrive(&sm.v_empty[st]);
  }
  if (n_tiles > 0 && wg == 0) named_sync(1);  // warpgroup 1's last turn

  const int bi = bh / f.h, hi = bh % f.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int row = row_w + g + 8 * r;
    if (row < f.s) {
      __nv_bfloat16* orow =
          out + ((static_cast<size_t>(bi) * f.s + row) * f.h + hi) * D;
      const float inv = 1.f / l;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<uint32_t*>(orow + 8 * jj + 2 * qd) =
            pack_bf16(o[4 * jj + 2 * r] * inv, o[4 * jj + 2 * r + 1] * inv);
      if (qd == 0)
        lse[static_cast<size_t>(bh) * f.s + row] = m_r[r] + logf(l);
    }
  }
}

// Block (x, y, z) is launch number L = x + X (y + Y z), and the blocks run
// in about that order: L takes query tile tiles - 1 - L / rows of row
// L % rows, so every row's heaviest causal tile starts before any lighter
// one.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 const FwdShape f) {
  constexpr int NB = D / 64;
  const long long launch = launch_index();
  if (launch >= f.rows * f.tiles) return;
  const int bh = static_cast<int>(launch % f.rows);
  const int m0 = (f.tiles - 1 - static_cast<int>(launch / f.rows)) * kFwdRows;
  int n_tiles = (f.t + kFwdKeys - 1) / kFwdKeys;
  if (f.causal) n_tiles = min(n_tiles, (m0 + kFwdRows - 1) / kFwdKeys + 1);

  FwdSmem<D>& sm = aligned_smem<FwdSmem<D>>();
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int i = 0; i < kFwdStages; ++i) {
      mbar_init(&sm.k_full[i], 1);
      mbar_init(&sm.v_full[i], 1);
      mbar_init(&sm.k_empty[i], 256);  // every consumer thread
      mbar_init(&sm.v_empty[i], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // the producer warp
    if (threadIdx.x == 256) {
      const int bi = bh / f.h, hi = bh % f.h, kvh = hi / (f.h / f.hk);
      constexpr uint32_t kTileBytes = kFwdKeys * D * 2;
      mbar_expect_tx(&sm.q_full, kFwdRows * D * 2);
      for (int b = 0; b < NB; ++b)
        tma_load(sm.q + b * kFwdRows * 64, &q_map, &sm.q_full, 64 * b, hi,
                 m0, bi);
      for (int it = 0; it < n_tiles; ++it) {
        const int n0 = (n_tiles - 1 - it) * kFwdKeys;
        const int st = it % kFwdStages;
        const uint32_t ph = ((it / kFwdStages) & 1) ^ 1;
        mbar_wait(&sm.k_empty[st], ph);
        mbar_expect_tx(&sm.k_full[st], kTileBytes);
        for (int b = 0; b < NB; ++b)
          tma_load(sm.k[st] + b * kFwdKeys * 64, &k_map, &sm.k_full[st],
                   64 * b, kvh, n0, bi);
        mbar_wait(&sm.v_empty[st], ph);
        mbar_expect_tx(&sm.v_full[st], kTileBytes);
        for (int b = 0; b < NB; ++b)
          tma_load(sm.v[st] + b * kFwdKeys * 64, &v_map, &sm.v_full[st],
                   64 * b, kvh, n0, bi);
      }
    }
  } else {  // the consumer warpgroups
    fwd_consumer<D>(sm, f, out, lse, wg, m0, bh, n_tiles);
  }
}

// ---- kernels 2 and 3, bf16: wgmma and TMA ---------------------------------
//
// The layouts are kernel 1's: every tile is d / 64 column blocks of
// (rows x 64) bf16, 128-byte swizzled, 1024-byte aligned. A block owns 128
// rows of its output (query rows for kernel 2, keys for kernel 3), one
// warpgroup 64 of them, and streams tiles of 64 rows of the other side
// (keys, or queries) through a ring of stages. An SS product reads both
// operands K-major (a 16-deep step of d moves 32 bytes inside a block); an
// RS product reads its B tile MN-major (a 16-deep step moves 16 rows of 128
// bytes; the next 64 columns of d are the next block).
//
// Kernel 2 keeps kernel 1's block, two consumer warpgroups and a producer
// warp (288 threads, 168 registers a thread, which it fits). Kernel 3 does
// not fit them: its block is the two consumer warpgroups alone (256
// threads, up to 255 registers), and its warp 0 issues the loads (see the
// note at the top).

constexpr int kBwdRows = 128;    // rows of the output per block
constexpr int kBwdTile = 64;     // rows of a streamed tile
constexpr int kDqStages = 2;     // ring depths
constexpr int kDkvStages = 3;
constexpr int kDqThreads = kFwdThreads;
constexpr int kDkvThreads = 256;

template <int D>
struct DqSmem {
  __nv_bfloat16 q[kBwdRows * D];
  __nv_bfloat16 dout[kBwdRows * D];
  __nv_bfloat16 out[kBwdRows * D];  // when delta is computed
  __nv_bfloat16 k[kDqStages][kBwdTile * D];
  __nv_bfloat16 v[kDqStages][kBwdTile * D];
  float delta[kBwdRows];
  uint64_t q_full;
  uint64_t kv_full[kDqStages], kv_empty[kDqStages];
};

template <int D>
struct DkvSmem {
  __nv_bfloat16 k[kBwdRows * D];
  __nv_bfloat16 v[kBwdRows * D];
  __nv_bfloat16 q[kDkvStages][kBwdTile * D];
  __nv_bfloat16 dout[kDkvStages][kBwdTile * D];
  alignas(128) float lse[kDkvStages][kBwdTile];  // of the tile's queries
  alignas(128) float delta[kDkvStages][kBwdTile];
  uint64_t kv_full;
  uint64_t q_full[kDkvStages], q_empty[kDkvStages];
};

struct BwdArgs {
  const __nv_bfloat16* out;   // kernel 2: given, delta is computed from it
  const __nv_bfloat16* dout;
  const float* lse;
  const float* delta;         // kernel 2 reads it when out is null
  float* delta_out;           // kernel 2 with out
  __nv_bfloat16* o0;          // dq or dk
  __nv_bfloat16* o1;          // dv
  int s, t, h, hk, causal, tiles;
  long long rows;             // b * h (kernel 2) or b * hk (kernel 3)
  float scale;
};

// One float of global memory into shared memory by cp.async, or a zero
// when !fill; cp_async_arrive(bar) makes `bar` count this thread's arrival
// once all its cp.async have landed.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool fill) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(fill ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_addr(bar)) : "memory");
}

// d (64 x 64) = A B^T over depth D, both K-major in shared memory: a_desc
// names a warpgroup's 64 rows of a kBwdRows-row A tile, b_desc a
// kBwdTile-row B tile.
template <int D>
__device__ __forceinline__ void issue_ss64(float (&d)[32], uint64_t a_desc,
                                           uint64_t b_desc) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int blk = kk / 4, step = (kk % 4) * 2;
    wgmma_ss_n64(d, a_desc + blk * (kBwdRows * 128 / 16) + step,
                 b_desc + blk * (kBwdTile * 128 / 16) + step, kk > 0);
  }
}

// Write a warp's accumulator rows to bf16 memory: the thread's pairs of
// its row + 8 r (r = 0, 1) at columns 8 j + 2 qd of the row at dst.
template <int D>
__device__ __forceinline__ void store_row(__nv_bfloat16* dst,
                                          const float (&acc)[D / 2], int r,
                                          int qd) {
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj)
    *reinterpret_cast<uint32_t*>(dst + 8 * jj + 2 * qd) =
        pack_bf16(acc[4 * jj + 2 * r], acc[4 * jj + 2 * r + 1]);
}

// Wait until the stage of streamed tile `it` in a ring of STAGES is free:
// the consumers have released the tile STAGES before it (at once for the
// first round).
template <int STAGES>
__device__ __forceinline__ void wait_stage(uint64_t* empty, int it) {
  mbar_wait(empty, ((it / STAGES) & 1) ^ 1);
}

// Kernel 2's loads, all from the producer warp's first thread.
template <int D>
struct DqLoads {
  const CUtensorMap* q;
  const CUtensorMap* k;
  const CUtensorMap* v;
  const CUtensorMap* dout;
  const CUtensorMap* out;  // null unless delta is computed
  int bi, hi, kvh, m0, n_tiles;

  __device__ __forceinline__ void q_rows(DqSmem<D>& sm) const {
    mbar_expect_tx(&sm.q_full, (out != nullptr ? 3 : 2) * kBwdRows * D * 2);
    for (int b = 0; b < D / 64; ++b) {
      tma_load(sm.q + b * kBwdRows * 64, q, &sm.q_full, 64 * b, hi, m0, bi);
      tma_load(sm.dout + b * kBwdRows * 64, dout, &sm.q_full, 64 * b, hi, m0,
               bi);
      if (out != nullptr)
        tma_load(sm.out + b * kBwdRows * 64, out, &sm.q_full, 64 * b, hi, m0,
                 bi);
    }
  }
  // Key tile `it` (keys (n_tiles - 1 - it) * 64 ..) into its stage.
  __device__ __forceinline__ void kv_tile(DqSmem<D>& sm, int it) const {
    const int st = it % kDqStages, n0 = (n_tiles - 1 - it) * kBwdTile;
    wait_stage<kDqStages>(&sm.kv_empty[st], it);
    mbar_expect_tx(&sm.kv_full[st], 2 * kBwdTile * D * 2);
    for (int b = 0; b < D / 64; ++b) {
      tma_load(sm.k[st] + b * kBwdTile * 64, k, &sm.kv_full[st], 64 * b, kvh,
               n0, bi);
      tma_load(sm.v[st] + b * kBwdTile * 64, v, &sm.kv_full[st], 64 * b, kvh,
               n0, bi);
    }
  }
};

// One consumer warpgroup of kernel 2: 64 query rows from row_wg, against
// key tiles n_tiles - 1 .. 0 (the masked ones first). Thread (warp, g, qd)
// holds rows row_w + g and + 8 of every accumulator, as in fwd_consumer.
template <int D>
__device__ __forceinline__ void dq_consumer(DqSmem<D>& sm, const BwdArgs& f,
                                            const DqLoads<D>& ld, int wg,
                                            int bh) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, qd = lane % 4;
  const int m0 = ld.m0, n_tiles = ld.n_tiles;
  const int row_wg = m0 + 64 * wg, row_w = row_wg + 16 * warp;

  mbar_wait(&sm.q_full, 0);
  // delta of this warpgroup's rows from out and dO in shared memory (zero
  // past s): two threads to a row, each over half its 16-byte pieces. The
  // two tiles share one swizzle, so a row's pieces pair up where they lie.
  if (ld.out != nullptr) {
    const int r = 64 * wg + tid / 2;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
      const int piece = (tid % 2) * (D / 16) + i;
      const int at = (piece / 8) * kBwdRows * 64 + r * 64 + (piece % 8) * 8;
      acc += dot<8>(sm.out + at, sm.dout + at);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (tid % 2 == 0) {
      sm.delta[r] = acc;
      if (m0 + r < f.s)
        f.delta_out[static_cast<size_t>(bh) * f.s + m0 + r] = acc;
    }
    warpgroup_sync(3 + wg);
  }
  float neg_lse[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_w + g + 8 * r;
    const size_t i = static_cast<size_t>(bh) * f.s + row;
    neg_lse[r] = row < f.s ? -f.lse[i] * kLog2e : 0.f;
    dl[r] = row >= f.s            ? 0.f
            : ld.out != nullptr ? sm.delta[row - m0]
                                : f.delta[i];
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float sc[32], dp[32];
  uint32_t ds[4][4];
  const uint64_t q_desc = wgmma_desc(sm.q + 64 * wg * 64, 16, 1024);
  const uint64_t o_desc = wgmma_desc(sm.dout + 64 * wg * 64, 16, 1024);
  const uint64_t k_desc = wgmma_desc(sm.k[0], 16, 1024);
  const uint64_t v_desc = wgmma_desc(sm.v[0], 16, 1024);
  const uint64_t kt_desc = wgmma_desc(sm.k[0], kBwdTile * 128, 1024);
  constexpr int stage = kBwdTile * D * 2 / 16;
  const float c = f.scale * kLog2e;

  // The warpgroups take turns to issue their products (named barriers 1
  // and 2, warpgroup 0 first). Under a causal mask warpgroup 0's first
  // n_dead key tiles lie past its diagonal: it takes their turns and
  // issues nothing. (A product under a branch would serialise every
  // wgmma of the kernel, ptxas C7518.)
  const int n_dead =
      f.causal ? max(0, n_tiles - 1 - (row_wg + 63) / kBwdTile) : 0;
  if (n_tiles > 0 && wg == 0) named_arrive(1);
  for (int it = 0; it < n_dead; ++it) {
    mbar_wait(&sm.kv_full[it % kDqStages], (it / kDqStages) & 1);
    pass_turns(wg);
    mbar_arrive(&sm.kv_empty[it % kDqStages]);
  }
  for (int it = n_dead; it < n_tiles; ++it) {
    const int st = it % kDqStages;
    const int n0 = (n_tiles - 1 - it) * kBwdTile;
    mbar_wait(&sm.kv_full[st], (it / kDqStages) & 1);
    named_sync(1 + wg);
    wgmma_fence();
    issue_ss64<D>(sc, q_desc, k_desc + st * stage);
    issue_ss64<D>(dp, o_desc, v_desc + st * stage);
    wgmma_commit();
    named_arrive(2 - wg);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    const bool edge =
        n0 + kBwdTile > f.t || (f.causal && n0 + kBwdTile - 1 > row_w);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = fast_exp2(fmaf(sc[4 * jj + e], c, neg_lse[r]));
        if (edge) {
          const int row = row_w + g + 8 * r;
          const int col = n0 + 8 * jj + 2 * qd + (e & 1);
          if (col >= f.t || (f.causal && col > row)) p = 0.f;
        }
        sc[4 * jj + e] = p * (dp[4 * jj + e] - dl[r]) * f.scale;
      }
    pack_p(ds, sc);  // ds in k's dtype
    named_sync(1 + wg);
    fence_regs(ds);
    fence_regs(dq);
    wgmma_fence();
    issue_pv<D, 4>(dq, ds, kt_desc + st * stage);
    wgmma_commit();
    named_arrive(2 - wg);
    wgmma_wait<0>();
    fence_regs(ds);
    fence_regs(dq);
    mbar_arrive(&sm.kv_empty[st]);
  }
  if (n_tiles > 0 && wg == 0) named_sync(1);  // warpgroup 1's last turn

  const int bi = bh / f.h, hi = bh % f.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_w + g + 8 * r;
    if (row < f.s)
      store_row<D>(f.o0 + ((static_cast<size_t>(bi) * f.s + row) * f.h + hi) *
                              D,
                   dq, r, qd);
  }
}

// Kernel 2, bf16. Launch L takes query tile tiles - 1 - L / rows of row
// L % rows: the heaviest causal tiles start first.
template <int D>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const __grid_constant__ CUtensorMap out_map,
                          const BwdArgs f) {
  const long long launch = launch_index();
  if (launch >= f.rows * f.tiles) return;
  const int bh = static_cast<int>(launch % f.rows);
  const int m0 = (f.tiles - 1 - static_cast<int>(launch / f.rows)) * kBwdRows;
  int n_tiles = (f.t + kBwdTile - 1) / kBwdTile;
  if (f.causal) n_tiles = min(n_tiles, (m0 + kBwdRows - 1) / kBwdTile + 1);
  const int hi = bh % f.h;
  const DqLoads<D> ld{&q_map, &k_map, &v_map, &do_map,
                      f.out != nullptr ? &out_map : nullptr, bh / f.h, hi,
                      hi / (f.h / f.hk), m0, n_tiles};

  DqSmem<D>& sm = aligned_smem<DqSmem<D>>();
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int i = 0; i < kDqStages; ++i) {
      mbar_init(&sm.kv_full[i], 1);
      mbar_init(&sm.kv_empty[i], 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 256) {  // the producer warp
    if (threadIdx.x == 256) {
      ld.q_rows(sm);
      for (int it = 0; it < n_tiles; ++it) ld.kv_tile(sm, it);
    }
  } else {  // the consumer warpgroups
    dq_consumer<D>(sm, f, ld, threadIdx.x / 128, bh);
  }
}

// Kernel 3's loads, all from warp 0.
template <int D>
struct DkvLoads {
  const CUtensorMap* q;
  const CUtensorMap* k;
  const CUtensorMap* v;
  const CUtensorMap* dout;
  const float* lse;
  const float* delta;
  int bi, kvh, group, h, s, n0, q_start, n_qt, n_it;

  __device__ __forceinline__ void kv_rows(DkvSmem<D>& sm) const {
    mbar_expect_tx(&sm.kv_full, 2 * kBwdRows * D * 2);
    for (int b = 0; b < D / 64; ++b) {
      tma_load(sm.k + b * kBwdRows * 64, k, &sm.kv_full, 64 * b, kvh, n0, bi);
      tma_load(sm.v + b * kBwdRows * 64, v, &sm.kv_full, 64 * b, kvh, n0, bi);
    }
  }
  // Query tile `it` (group member it / n_qt, queries q_start + 64 (it %
  // n_qt) ..) into its stage: Q and dO by TMA from lane 0, the tile's lse
  // and delta by cp.async from every lane (a (b h, s) row of them is
  // 16-byte aligned only when s % 4 == 0, which TMA needs; zeros past s).
  __device__ __forceinline__ void q_tile(DkvSmem<D>& sm, int it,
                                         int lane) const {
    const int st = it % kDkvStages;
    const int head = kvh * group + it / n_qt;
    const int q0 = q_start + (it % n_qt) * kBwdTile;
    wait_stage<kDkvStages>(&sm.q_empty[st], it);
    if (lane == 0) {
      mbar_expect_tx(&sm.q_full[st], 2 * kBwdTile * D * 2);
      for (int b = 0; b < D / 64; ++b) {
        tma_load(sm.q[st] + b * kBwdTile * 64, q, &sm.q_full[st], 64 * b,
                 head, q0, bi);
        tma_load(sm.dout[st] + b * kBwdTile * 64, dout, &sm.q_full[st],
                 64 * b, head, q0, bi);
      }
    }
    const size_t row0 = (static_cast<size_t>(bi) * h + head) * s;
    for (int i = lane; i < kBwdTile; i += 32) {
      const int col = q0 + i;
      const size_t at = row0 + (col < s ? col : 0);
      cp_async4(&sm.lse[st][i], lse + at, col < s);
      cp_async4(&sm.delta[st][i], delta + at, col < s);
    }
    cp_async_arrive(&sm.q_full[st]);
  }
};

// One consumer warpgroup of kernel 3: 64 keys from key_wg, against n_it
// query tiles (group member major, tiles ascending from q_start). Thread
// (warp, g, qd) holds keys key_w + g and + 8 of every accumulator; in S^T
// and dP^T, entry 4 j + e is query 8 j + 2 qd + (e & 1) of the tile.
template <int D>
__device__ __forceinline__ void dkv_consumer(DkvSmem<D>& sm,
                                             const BwdArgs& f,
                                             const DkvLoads<D>& ld, int wg,
                                             int bkv) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, qd = lane % 4;
  const int n_qt = ld.n_qt, n_it = ld.n_it, q_start = ld.q_start;
  const int key_wg = ld.n0 + 64 * wg, key_w = key_wg + 16 * warp;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  float sc[32], dp[32];
  uint32_t pa[4][4], da[4][4];
  const uint64_t k_desc = wgmma_desc(sm.k + 64 * wg * 64, 16, 1024);
  const uint64_t v_desc = wgmma_desc(sm.v + 64 * wg * 64, 16, 1024);
  const uint64_t q_desc = wgmma_desc(sm.q[0], 16, 1024);
  const uint64_t o_desc = wgmma_desc(sm.dout[0], 16, 1024);
  const uint64_t qt_desc = wgmma_desc(sm.q[0], kBwdTile * 128, 1024);
  const uint64_t ot_desc = wgmma_desc(sm.dout[0], kBwdTile * 128, 1024);
  constexpr int stage = kBwdTile * D * 2 / 16;
  const float c = f.scale * kLog2e;
  // Release tile `it`'s stage; warp 0 then refills the stage of the tile
  // before it, which both warpgroups have released by now.
  auto done = [&](int it) {
    mbar_arrive(&sm.q_empty[it % kDkvStages]);
    if (threadIdx.x < 32 && it >= 1 && it - 1 + kDkvStages < n_it)
      ld.q_tile(sm, it - 1 + kDkvStages, threadIdx.x);
  };

  mbar_wait(&sm.kv_full, 0);
  // Turns as in dq_consumer. Under a causal mask warpgroup 1's first
  // n_dead query tiles of each group member lie before its first key: it
  // takes their turns and issues nothing.
  const int n_dead =
      f.causal ? min(n_qt, max(0, (key_wg - q_start) / kBwdTile)) : 0;
  if (n_it > 0 && wg == 0) named_arrive(1);
  for (int it = 0; it < n_it;) {
    for (int j = 0; j < n_dead; ++j, ++it) {
      mbar_wait(&sm.q_full[it % kDkvStages], (it / kDkvStages) & 1);
      pass_turns(wg);
      done(it);
    }
    for (int j = n_dead; j < n_qt; ++j, ++it) {
      const int st = it % kDkvStages;
      const int q0 = q_start + j * kBwdTile;
      mbar_wait(&sm.q_full[st], (it / kDkvStages) & 1);
      named_sync(1 + wg);
      wgmma_fence();
      issue_ss64<D>(sc, k_desc, q_desc + st * stage);
      issue_ss64<D>(dp, v_desc, o_desc + st * stage);
      wgmma_commit();
      named_arrive(2 - wg);
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      const bool edge = q0 + kBwdTile > f.s || key_w + 16 > f.t ||
                        (f.causal && q0 < key_w + 15);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(sm.lse[st] + 8 * jj + 2 * qd);
        const float2 d2 =
            *reinterpret_cast<const float2*>(sm.delta[st] + 8 * jj + 2 * qd);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse = e & 1 ? l2.y : l2.x;
          float p = fast_exp2(fmaf(sc[4 * jj + e], c, -lse * kLog2e));
          if (edge) {
            const int key = key_w + g + 8 * (e >> 1);
            const int col = q0 + 8 * jj + 2 * qd + (e & 1);
            if (col >= f.s || key >= f.t || (f.causal && col < key)) p = 0.f;
          }
          sc[4 * jj + e] = p;
          dp[4 * jj + e] =
              p * (dp[4 * jj + e] - (e & 1 ? d2.y : d2.x)) * f.scale;
        }
      }
      pack_p(pa, sc);  // p^T in dout's dtype
      pack_p(da, dp);  // ds^T in q's dtype
      named_sync(1 + wg);
      fence_regs(pa);
      fence_regs(da);
      fence_regs(dk);
      fence_regs(dv);
      wgmma_fence();
      issue_pv<D, 4>(dv, pa, ot_desc + st * stage);
      issue_pv<D, 4>(dk, da, qt_desc + st * stage);
      wgmma_commit();
      named_arrive(2 - wg);
      wgmma_wait<0>();
      fence_regs(pa);
      fence_regs(da);
      fence_regs(dk);
      fence_regs(dv);
      done(it);
    }
  }
  if (n_it > 0 && wg == 0) named_sync(1);  // warpgroup 1's last turn

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_w + g + 8 * r;
    if (key < f.t) {
      const size_t off =
          ((static_cast<size_t>(ld.bi) * f.t + key) * f.hk + ld.kvh) * D;
      store_row<D>(f.o0 + off, dk, r, qd);
      store_row<D>(f.o1 + off, dv, r, qd);
    }
  }
}

// Kernel 3, bf16. Launch L takes key tile L / rows of row L % rows: under
// a causal mask the first key tiles see the most queries, so they start
// first.
template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const BwdArgs f) {
  const long long launch = launch_index();
  if (launch >= f.rows * f.tiles) return;
  const int bkv = static_cast<int>(launch % f.rows);
  const int n0 = static_cast<int>(launch / f.rows) * kBwdRows;
  // Query rows before n0 see none of these keys under the causal mask.
  const int q_start = f.causal ? (n0 / kBwdTile) * kBwdTile : 0;
  const int n_qt =
      q_start < f.s ? (f.s - q_start + kBwdTile - 1) / kBwdTile : 0;
  const int group = f.h / f.hk;
  const DkvLoads<D> ld{&q_map, &k_map, &v_map, &do_map, f.lse, f.delta,
                       bkv / f.hk, bkv % f.hk, group, f.h, f.s, n0,
                       q_start, n_qt, group * n_qt};

  DkvSmem<D>& sm = aligned_smem<DkvSmem<D>>();
  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int i = 0; i < kDkvStages; ++i) {
      mbar_init(&sm.q_full[i], 1 + 32);  // TMA's bytes, warp 0's cp.async
      mbar_init(&sm.q_empty[i], kDkvThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) ld.kv_rows(sm);
    for (int it = 0; it < min(kDkvStages, ld.n_it); ++it)
      ld.q_tile(sm, it, threadIdx.x);
  }
  dkv_consumer<D>(sm, f, ld, threadIdx.x / 128, bkv);
}

// ---- launches -------------------------------------------------------------

dim3 row_grid(int tiles, int rows) {
  const int y = rows < 1 ? 1 : (rows < kMaxGridY ? rows : kMaxGridY);
  const int z = (rows + y - 1) / y;
  return dim3(tiles, y, z < 1 ? 1 : z);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* lse_in;
  const void* delta;
  void* o0;  // out, dq or dk
  void* o1;  // lse or dv
  int b, s, t, h, hk, causal;
  float scale;
  cudaStream_t stream;
  const void* out = nullptr;  // kernel 2: given, it computes delta from it
  void* delta_out = nullptr;  // ... into this (b, h, s) float32 buffer
};

template <int D>
constexpr int fwd_smem() {
  return ((kBlockM + 4 * kFwdBlockN) * (D + vec<float>()) +
          kWarps * 16 * (kFwdBlockN + vec<float>())) *
         static_cast<int>(sizeof(float));
}
template <int D>
constexpr int dq_smem() {  // + the delta of the block's rows
  return ((2 * kBlockM + 4 * kDqBlockN) * (D + vec<float>()) +
          kWarps * 16 * (kDqBlockN + vec<float>()) + kBlockM) *
         static_cast<int>(sizeof(float));
}
template <int D>
constexpr int dkv_smem() {
  return ((2 * kBlockM + 4 * kDkvBlockQ) * (D + vec<float>()) +
          kWarps * 16 * (kDkvBlockQ + vec<float>())) *
         static_cast<int>(sizeof(float));
}

// Raise a kernel's dynamic shared-memory limit to `bytes`, once per device:
// `ready` is the calling launcher's own record of the devices done.
constexpr int kMaxDevices = 64;
cudaError_t smem_limit_once(const void* kernel, int bytes, bool* ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && ready[dev])) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < kMaxDevices) ready[dev] = true;
  return err;
}

template <int D>
int fwd_f32(const Args& a) {
  constexpr int smem = fwd_smem<D>();
  static bool ready[kMaxDevices] = {};
  auto kern = flash_fwd_kernel<D>;
  const cudaError_t err =
      smem_limit_once(reinterpret_cast<const void*>(kern), smem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = row_grid((a.s + kBlockM - 1) / kBlockM, a.b * a.h);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o0),
      static_cast<float*>(a.o1), a.s, a.t, a.h, a.hk, a.causal, a.scale,
      a.b * a.h);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, taken from the driver once through the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Tensor map of a bf16 (batch, rows, heads, d) tensor for boxes of 64
// columns of one head over `box_rows` rows, 128-byte swizzled; reads past
// `rows` are zeros. A tensor with no rows gets a zero map, never read.
bool bf16_map(CUtensorMap* map, const void* base, int batch, int rows,
              int heads, int d, int box_rows) {
  *map = CUtensorMap{};
  if (rows == 0) return true;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(heads) * d * 2,
                                 static_cast<cuuint64_t>(rows) * heads * d *
                                     2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int fwd_bf16(const Args& a) {
  static bool ready[kMaxDevices] = {};
  const cudaError_t err = smem_limit_once(
      reinterpret_cast<const void*>(flash_fwd_wgmma_kernel<D>),
      wgmma_smem<FwdSmem<D>>(), ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap q_map, k_map, v_map;
  if (!bf16_map(&q_map, a.q, a.b, a.s, a.h, D, kFwdRows) ||
      !bf16_map(&k_map, a.k, a.b, a.t, a.hk, D, kFwdKeys) ||
      !bf16_map(&v_map, a.v, a.b, a.t, a.hk, D, kFwdKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (a.s + kFwdRows - 1) / kFwdRows;
  const FwdShape f{a.s, a.t, a.h, a.hk, a.causal, tiles,
                   static_cast<long long>(a.b) * a.h, a.scale};
  const dim3 grid = row_grid(tiles, a.b * a.h);
  flash_fwd_wgmma_kernel<D>
      <<<grid, kFwdThreads, wgmma_smem<FwdSmem<D>>(), a.stream>>>(
          q_map, k_map, v_map, static_cast<__nv_bfloat16*>(a.o0),
          static_cast<float*>(a.o1), f);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_dq_f32(const Args& a) {
  constexpr int smem = dq_smem<D>();
  static bool ready[kMaxDevices] = {};
  auto kern = flash_bwd_dq_kernel<D>;
  const cudaError_t err =
      smem_limit_once(reinterpret_cast<const void*>(kern), smem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = row_grid((a.s + kBlockM - 1) / kBlockM, a.b * a.h);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta), static_cast<const float*>(a.out),
      static_cast<float*>(a.delta_out), static_cast<float*>(a.o0), a.s, a.t,
      a.h, a.hk, a.causal, a.scale, a.b * a.h);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_dkv_f32(const Args& a) {
  constexpr int smem = dkv_smem<D>();
  static bool ready[kMaxDevices] = {};
  auto kern = flash_bwd_dkv_kernel<D>;
  const cudaError_t err =
      smem_limit_once(reinterpret_cast<const void*>(kern), smem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = row_grid((a.t + kBlockM - 1) / kBlockM, a.b * a.hk);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta), static_cast<float*>(a.o0),
      static_cast<float*>(a.o1), a.s, a.t, a.h, a.hk, a.causal, a.scale,
      a.b * a.hk);
  return static_cast<int>(cudaGetLastError());
}

// The tensor maps of kernels 2 and 3 (bf16): q and dout in boxes of
// q_rows rows, k and v in boxes of kv_rows.
bool bwd_maps(const Args& a, int d, int q_rows, int kv_rows,
              CUtensorMap (&m)[4]) {
  return bf16_map(&m[0], a.q, a.b, a.s, a.h, d, q_rows) &&
         bf16_map(&m[1], a.k, a.b, a.t, a.hk, d, kv_rows) &&
         bf16_map(&m[2], a.v, a.b, a.t, a.hk, d, kv_rows) &&
         bf16_map(&m[3], a.dout, a.b, a.s, a.h, d, q_rows);
}

BwdArgs bwd_args(const Args& a, int tiles, long long rows) {
  return BwdArgs{static_cast<const __nv_bfloat16*>(a.out),
                 static_cast<const __nv_bfloat16*>(a.dout),
                 static_cast<const float*>(a.lse_in),
                 static_cast<const float*>(a.delta),
                 static_cast<float*>(a.delta_out),
                 static_cast<__nv_bfloat16*>(a.o0),
                 static_cast<__nv_bfloat16*>(a.o1),
                 a.s, a.t, a.h, a.hk, a.causal, tiles, rows, a.scale};
}

template <int D>
int bwd_dq_bf16(const Args& a) {
  constexpr int smem = wgmma_smem<DqSmem<D>>();
  static bool ready[kMaxDevices] = {};
  const cudaError_t err = smem_limit_once(
      reinterpret_cast<const void*>(flash_bwd_dq_wgmma_kernel<D>), smem,
      ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap m[4], out_map{};
  if (!bwd_maps(a, D, kBwdRows, kBwdTile, m) ||
      (a.out != nullptr &&
       !bf16_map(&out_map, a.out, a.b, a.s, a.h, D, kBwdRows)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (a.s + kBwdRows - 1) / kBwdRows;
  flash_bwd_dq_wgmma_kernel<D>
      <<<row_grid(tiles, a.b * a.h), kDqThreads, smem, a.stream>>>(
          m[0], m[1], m[2], m[3], out_map,
          bwd_args(a, tiles, static_cast<long long>(a.b) * a.h));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_dkv_bf16(const Args& a) {
  constexpr int smem = wgmma_smem<DkvSmem<D>>();
  static bool ready[kMaxDevices] = {};
  const cudaError_t err = smem_limit_once(
      reinterpret_cast<const void*>(flash_bwd_dkv_wgmma_kernel<D>), smem,
      ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap m[4];
  if (!bwd_maps(a, D, kBwdTile, kBwdRows, m))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (a.t + kBwdRows - 1) / kBwdRows;
  flash_bwd_dkv_wgmma_kernel<D>
      <<<row_grid(tiles, a.b * a.hk), kDkvThreads, smem, a.stream>>>(
          m[0], m[1], m[2], m[3],
          bwd_args(a, tiles, static_cast<long long>(a.b) * a.hk));
  return static_cast<int>(cudaGetLastError());
}

// Instantiations: head_dim 64 and 128, float32 and bfloat16.
#define MPI_TPU_DISPATCH(NAME)                                         \
  int NAME##_any(const Args& a, int d, int is_bf16) {                  \
    if (is_bf16) {                                                     \
      if (d == 64) return NAME##_bf16<64>(a);                          \
      if (d == 128) return NAME##_bf16<128>(a);                        \
    } else {                                                           \
      if (d == 64) return NAME##_f32<64>(a);                           \
      if (d == 128) return NAME##_f32<128>(a);                         \
    }                                                                  \
    return static_cast<int>(cudaErrorInvalidValue);                    \
  }

MPI_TPU_DISPATCH(fwd)
MPI_TPU_DISPATCH(bwd_dq)
MPI_TPU_DISPATCH(bwd_dkv)

#undef MPI_TPU_DISPATCH

}  // namespace

extern "C" {

// Each function launches one kernel on `stream` and returns the CUDA error
// code of the launch (0 on success). Layouts and dtypes as at the top of
// this file; is_bf16 selects bfloat16 (else float32); d is 64 or 128.

// Kernel 1: out (b, s, h, d) and lse (b, h, s).
int flash_fwd(const void* q, const void* k, const void* v, void* out,
              void* lse, int b, int s, int t, int h, int hk, int d,
              int causal, float scale, int is_bf16, void* stream) {
  const Args a{q, k, v, nullptr, nullptr, nullptr, out, lse, b, s, t, h, hk,
               causal, scale, static_cast<cudaStream_t>(stream)};
  return fwd_any(a, d, is_bf16);
}

// Kernel 2: dq (b, s, h, d) from dout, lse and delta = rowsum(dout * out).
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int b, int s, int t, int h, int hk, int d,
                 int causal, float scale, int is_bf16, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, b, s, t, h, hk,
               causal, scale, static_cast<cudaStream_t>(stream)};
  return bwd_dq_any(a, d, is_bf16);
}

// Kernel 2 from out: dq, and delta = rowsum(dout * out) (b, h, s) float32,
// which the kernel computes and writes for kernel 3.
int flash_bwd_dq_delta(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* out,
                       void* delta, void* dq, int b, int s, int t, int h,
                       int hk, int d, int causal, float scale, int is_bf16,
                       void* stream) {
  const Args a{q, k, v, dout, lse, nullptr, dq, nullptr, b, s, t, h, hk,
               causal, scale, static_cast<cudaStream_t>(stream), out, delta};
  return bwd_dq_any(a, d, is_bf16);
}

// Kernel 3: dk and dv (b, t, hk, d).
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int b, int s, int t, int h, int hk,
                  int d, int causal, float scale, int is_bf16,
                  void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, b, s, t, h, hk,
               causal, scale, static_cast<cudaStream_t>(stream)};
  return bwd_dkv_any(a, d, is_bf16);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
