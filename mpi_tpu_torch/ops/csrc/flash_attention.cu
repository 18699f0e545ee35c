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
// Kernel 1, flash_fwd_kernel, replaces mpi_tpu/ops/attention.py:
// _flash_kernel_fwd_res. Kernel 2, flash_bwd_dq_kernel, replaces
// _flash_bwd_dq_kernel. Kernel 3, flash_bwd_dkv_kernel, replaces
// _flash_bwd_dkv_kernel. The TPU kernels walk one reduction axis as a
// sequential grid axis with VMEM scratch; here one thread block owns one
// output tile and walks that axis in a loop, with its state in registers.
//
// What bounds them on this card: operations. At the flagship training shape
// (b 8, s = t 1024, h 8, d 128, bf16, causal) kernel 1 does 2 products of
// about 8.6 GFLOP each against about 67 MB of q, k, v and out, some 250
// FLOPs per byte; kernels 2 and 3 do 3 and 4 such products. The tensor
// cores have to do the products, and the tiles have to be reused from
// shared memory:
//   * bf16 products are mma.sync m16n8k16 with float32 accumulators; each
//     warp owns 16 rows of the output tile, so the 4 warps of a block share
//     each K/V (or Q/dO) tile staged in shared memory;
//   * tiles are staged by cp.async, double-buffered: the next tile's loads
//     are all issued before the current tile is used;
//   * shared-memory rows are padded by 16 bytes, so the fragment loads of a
//     warp hit 32 different banks;
//   * p and ds go through a small per-warp shared-memory tile on their way
//     from the accumulator layout to the A operand of the next product;
//   * causal tiles past the diagonal are skipped per block and per warp,
//     and the ragged edge (s or t not a multiple of a tile) is zero-filled
//     on load and masked, so no shape needs padding outside the kernel.
// Not done yet: wgmma and TMA (the tensor cores' full rate on Hopper), warp
// specialisation, and keeping p in registers between the two products.
// The float32 instantiation does its products with FMAs on the CUDA cores
// in the same layout; it exists for exact checks and is slow.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// Two neighbouring elements, rounded to T (lower index at lower address).
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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

// ---- warp-level products ----------------------------------------------
//
// c[j] += A (16 x K) * B (K x 8 NT) for one warp, in the accumulator layout
// of mma.sync m16n8: lane (g = lane / 4, q = lane % 4) holds c[j][0..1] at
// row g, columns 8 j + 2 q + {0, 1}, and c[j][2..3] at row g + 8. A is
// row-major in shared memory (lda elements a row). B is row-major [k][n]
// when BT is false, or given as its transpose [n][k] when BT is true.

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool BT, int NT, int K>
__device__ __forceinline__ void warp_gemm(float (&c)[NT][4],
                                          const __nv_bfloat16* a, int lda,
                                          const __nv_bfloat16* b, int ldb,
                                          int g, int q) {
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t fa[4];
    fa[0] = ld_pair(a + g * lda + k0 + 2 * q);
    fa[1] = ld_pair(a + (g + 8) * lda + k0 + 2 * q);
    fa[2] = ld_pair(a + g * lda + k0 + 8 + 2 * q);
    fa[3] = ld_pair(a + (g + 8) * lda + k0 + 8 + 2 * q);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = 8 * j + g;
      uint32_t fb[2];
      if (BT) {
        fb[0] = ld_pair(b + n * ldb + k0 + 2 * q);
        fb[1] = ld_pair(b + n * ldb + k0 + 8 + 2 * q);
      } else {
        const __nv_bfloat16* col = b + (k0 + 2 * q) * ldb + n;
        fb[0] = pack(col[0], col[ldb]);
        fb[1] = pack(col[8 * ldb], col[9 * ldb]);
      }
      mma_bf16(c[j], fa, fb);
    }
  }
}

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

// Write a warp's 16 x 8 NT accumulator tile, rounded to T, into shared rows
// of ld elements.
template <typename T, int NT>
__device__ __forceinline__ void stash(T* dst, int ld, const float (&c)[NT][4],
                                      int g, int q) {
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

// ---- kernel 1: forward --------------------------------------------------
//
// One block per (query tile of 64 rows, b * h). Loops over key tiles of 64,
// stopping at the diagonal when causal; m, l and the output accumulator
// stay in registers (float32) and out and lse are written once.

template <typename T, int D>
__device__ __forceinline__ void
flash_fwd_tile(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out,
               float* __restrict__ lse, int s, int t, int h, int hk,
               int causal, float scale, int bh) {
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
      stash<T, NS>(sPw, LDP, sc, g, qd);  // p in v's dtype
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

// ---- kernel 2: dq -------------------------------------------------------
//
// One block per (query tile of 64 rows, b * h). Loops over key tiles of 32
// up to the diagonal; p = exp(q k * scale - lse), ds = p (dp - delta) scale,
// dq += ds K accumulates in float32 registers and is written once.

template <typename T, int D>
__device__ __forceinline__ void
flash_bwd_dq_tile(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq, int s,
                  int t, int h, int hk, int causal, float scale, int bh) {
  constexpr int BM = kBlockM, BN = kDqBlockN;
  constexpr int LD = D + vec<T>(), LDP = BN + vec<T>();
  constexpr int NS = BN / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sO = sQ + BM * LD;      // dout rows
  T* sK = sO + BM * LD;      // two buffers
  T* sV = sK + 2 * BN * LD;  // two buffers
  T* sS = sV + 2 * BN * LD;  // one 16 x BN ds tile per warp

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

  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_w + g + 8 * r;
    const size_t i = static_cast<size_t>(bh) * s + row;
    lse_r[r] = row < s ? lse[i] : 0.f;
    delta_r[r] = row < s ? delta[i] : 0.f;
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
      stash<T, NS>(sSw, LDP, sc, g, qd);  // ds in k's dtype
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

// ---- kernel 3: dk, dv -----------------------------------------------------
//
// One block per (key tile of 64, b * hk). Loops over the group's query heads
// and, for each, over query tiles of 32 from the first one that reaches the
// key tile when causal. Works on the transposed products (keys as rows):
// p^T = exp(k q * scale - lse), dv += p^T dO, ds^T = p^T (dp^T - delta)
// scale, dk += ds^T Q. dk and dv accumulate in float32 registers and are
// written once per kv head: no atomics.

template <typename T, int D>
__device__ __forceinline__ void
flash_bwd_dkv_tile(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, int s, int t, int h, int hk,
                   int causal, float scale, int bkv) {
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
      stash<T, NS>(sPw, LDP, sc, g, qd);  // p^T in dout's dtype
      __syncwarp();
      warp_gemm<false, NO, BQ>(dv_acc, sPw, LDP, sOi, LD, g, qd);
      warp_gemm<true, NS, D>(dp, sVw, LD, sOi, LD, g, qd);
#pragma unroll
      for (int jj = 0; jj < NS; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[jj][e] = sc[jj][e] * (dp[jj][e] - dlt[jj][e & 1]) * scale;
      __syncwarp();  // every lane has read p^T
      stash<T, NS>(sPw, LDP, sc, g, qd);  // ds^T in q's dtype
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int s, int t, int h, int hk,
                 int causal, float scale, int rows) {
  const int bh = blockIdx.y + gridDim.y * blockIdx.z;
  if (bh < rows) {
    flash_fwd_tile<T, D>(q, k, v, out, lse, s, t, h, hk, causal, scale, bh);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int s, int t, int h, int hk, int causal, float scale,
                    int rows) {
  const int bh = blockIdx.y + gridDim.y * blockIdx.z;
  if (bh < rows) {
    flash_bwd_dq_tile<T, D>(q, k, v, dout, lse, delta, dq, s, t, h, hk,
                            causal, scale, bh);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int s, int t, int h, int hk,
                     int causal, float scale, int rows) {
  const int bkv = blockIdx.y + gridDim.y * blockIdx.z;
  if (bkv < rows) {
    flash_bwd_dkv_tile<T, D>(q, k, v, dout, lse, delta, dk, dv, s, t, h, hk,
                             causal, scale, bkv);
  }
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
};

template <typename T, int D>
constexpr int fwd_smem() {
  return ((kBlockM + 4 * kFwdBlockN) * (D + vec<T>()) +
          kWarps * 16 * (kFwdBlockN + vec<T>())) *
         static_cast<int>(sizeof(T));
}
template <typename T, int D>
constexpr int dq_smem() {
  return ((2 * kBlockM + 4 * kDqBlockN) * (D + vec<T>()) +
          kWarps * 16 * (kDqBlockN + vec<T>())) *
         static_cast<int>(sizeof(T));
}
template <typename T, int D>
constexpr int dkv_smem() {
  return ((2 * kBlockM + 4 * kDkvBlockQ) * (D + vec<T>()) +
          kWarps * 16 * (kDkvBlockQ + vec<T>())) *
         static_cast<int>(sizeof(T));
}

template <typename T, int D>
int fwd(const Args& a) {
  constexpr int smem = fwd_smem<T, D>();
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = row_grid((a.s + kBlockM - 1) / kBlockM, a.b * a.h);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o0),
      static_cast<float*>(a.o1), a.s, a.t, a.h, a.hk, a.causal, a.scale,
      a.b * a.h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd_dq(const Args& a) {
  constexpr int smem = dq_smem<T, D>();
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = row_grid((a.s + kBlockM - 1) / kBlockM, a.b * a.h);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta), static_cast<T*>(a.o0), a.s, a.t,
      a.h, a.hk, a.causal, a.scale, a.b * a.h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd_dkv(const Args& a) {
  constexpr int smem = dkv_smem<T, D>();
  auto kern = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = row_grid((a.t + kBlockM - 1) / kBlockM, a.b * a.hk);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta), static_cast<T*>(a.o0),
      static_cast<T*>(a.o1), a.s, a.t, a.h, a.hk, a.causal, a.scale,
      a.b * a.hk);
  return static_cast<int>(cudaGetLastError());
}

// Instantiations: head_dim 64 and 128, float32 and bfloat16.
#define MPI_TPU_DISPATCH(NAME)                                         \
  int NAME##_any(const Args& a, int d, int is_bf16) {                  \
    if (is_bf16) {                                                     \
      if (d == 64) return NAME<__nv_bfloat16, 64>(a);                  \
      if (d == 128) return NAME<__nv_bfloat16, 128>(a);                \
    } else {                                                           \
      if (d == 64) return NAME<float, 64>(a);                          \
      if (d == 128) return NAME<float, 128>(a);                        \
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
