// Flash-decode attention for Hopper (sm_90a): one query position per
// (batch, head) against the KV cache, read in place in its storage layout
// (b, t, kv, hd).
//
// Replaces the TPU kernel mpi_tpu/ops/decode_attention.py:_decode_kernel
// (launched by flash_decode_attention there). Same function and edge
// semantics: columns 0 .. n_valid are live, inputs stay in their stored
// dtype, the softmax state (m, l, acc) is float32, p is rounded to v's
// dtype before the PV product, and an empty live prefix (n_valid < 0)
// gives a zero output with lse = m + log(1e-30) ~ -1e30. As there, n_valid
// may be read from device memory, so a caller need not sync the host.
//
// What bounds it on this card: bytes. Each live K and V row is read once
// and does 2 * hd FLOPs per query row against 2 * hd * sizeof(T) bytes, so
// with a GQA group of g rows the kernel does about g / sizeof(T) FLOPs per
// byte, far below the ~295 FLOPs per byte where an H100's tensor cores
// become the limit. At decode sizes the cache is a few MB, so what costs
// time is latency: too few blocks, and memory round trips in series. The
// design keeps each block's loads in flight and, where the cache is long
// enough to pay for it, spreads one (b, kv head) over several SMs:
//   * The cache positions are split across a thread-block cluster. Each
//     (b, kv head, chunk of up to 8 group rows) is a cluster of S blocks
//     (S <= 8, the portable cluster size, chosen by the wrapper from t and
//     the SM count: kernel_splits in ops/decode_attention.py), and block r
//     of the cluster takes positions [r t / S, (r + 1) t / S). The wrapper
//     keeps the blocks within the SMs and gives each at least four load
//     units: a cluster launch costs about 1.2 us more than a plain one on
//     an H100, so at the flagship decode shape (b 8, kv 8, t 256) S is 1
//     (64 blocks, launched without the cluster attribute), and from t 512
//     at the same widths S is 2 (128 blocks). S depends on t, not on
//     n_valid; a block whose positions lie past the live prefix issues no
//     load and leaves an empty partial (m = -1e30, l = 0, acc = 0).
//   * hd / VEC neighbouring threads (a key group) read one key row in
//     16-byte pieces, and the block's KPP key groups take its keys in
//     turn. A batch is P keys per key group (KPP * P keys, the load unit):
//     each thread issues the K and the V loads of a batch together, and
//     those of the next batch before it uses the current one, so two
//     batches are in flight. Dead positions are never read.
//   * Each key group keeps its own running (m, l, acc) per query row in
//     registers. A score is reduced across the key group by shuffles, so
//     the key loop touches no shared memory and no barrier. In bf16, p is
//     rounded at the key group's running max.
//   * At the end the key groups merge through shared memory (the block's
//     max, each group rescaled to it, summed across a warp by shuffles and
//     then across warps in warp order), and the S blocks merge through
//     distributed shared memory: after cluster.sync(), block rank 0 reads
//     the S partials (m, l, acc) in rank order and writes out and lse, and
//     the cluster syncs again before any block exits. No atomics, no
//     global scratch, no second launch: every output is written once, and
//     two calls give the same bits.
//   * QK dot products and the PV accumulation are float32 FMAs on the CUDA
//     cores: at g rows per key there is nothing for the tensor cores to do.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;
constexpr int kMaxSplits = 8;  // the portable cluster size
constexpr float kNegInf = -1e30f;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  using Raw = float4;  // 16 bytes
  static constexpr int kVec = 4;
  __device__ static void unpack(const Raw& r, float* out) {
    out[0] = r.x;
    out[1] = r.y;
    out[2] = r.z;
    out[3] = r.w;
  }
  __device__ static float round(float x) { return x; }
  __device__ static float to_out(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  using Raw = uint4;  // 16 bytes
  static constexpr int kVec = 8;
  __device__ static void unpack(const Raw& r, float* out) {
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(pairs[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ static __nv_bfloat16 to_out(float x) {
    return __float2bfloat16_rn(x);
  }
};

// Work split of one block for element type T and head_dim HD. The Python
// wrapper mirrors UNIT in _load_unit and by_rows in _rows
// (ops/decode_attention.py); tests/test_torch_port_rules.py reads these
// definitions back to check that the two agree.
template <typename T, int HD>
struct Shape {
  static constexpr int VEC = Elem<T>::kVec;
  static constexpr int TPK = (HD / VEC < 32) ? HD / VEC : 32;  // threads/key
  static constexpr int NV = HD / (VEC * TPK);  // 16-byte pieces per thread
  static constexpr int EPT = NV * VEC;         // elements per thread per key
  static constexpr int KPP = kThreads / TPK;   // key groups of the block
  static constexpr int P = 4 / NV;             // keys per key group per batch
  static constexpr int UNIT = KPP * P;         // keys per batch of the block
  static_assert(HD % (VEC * TPK) == 0 && NV <= 4, "unsupported head_dim");
};

// The K and V pieces of this thread for one batch, all loads issued before
// any is used; positions at or past `j_end` are not read (zeros).
template <typename T, int HD>
__device__ __forceinline__ void load_batch(
    const T* kbase, const T* vbase, size_t row_stride, int j0, int j_end,
    int kg, typename Elem<T>::Raw (&kr)[Shape<T, HD>::P][Shape<T, HD>::NV],
    typename Elem<T>::Raw (&vr)[Shape<T, HD>::P][Shape<T, HD>::NV]) {
  using S = Shape<T, HD>;
  using Raw = typename Elem<T>::Raw;
#pragma unroll
  for (int p = 0; p < S::P; ++p) {
    const int j = j0 + p * S::KPP + kg;
    const bool live = j < j_end;
#pragma unroll
    for (int n = 0; n < S::NV; ++n) {
      const size_t at = j * row_stride + n * S::TPK * S::VEC;
      kr[p][n] = live ? *reinterpret_cast<const Raw*>(kbase + at) : Raw{};
      vr[p][n] = live ? *reinterpret_cast<const Raw*>(vbase + at) : Raw{};
    }
  }
}

// One batch into this key group's running (m, l, acc) of every row.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void update(
    typename Elem<T>::Raw (&kr)[Shape<T, HD>::P][Shape<T, HD>::NV],
    typename Elem<T>::Raw (&vr)[Shape<T, HD>::P][Shape<T, HD>::NV],
    int j0, int j_end, int kg, float scale,
    float (&qr)[ROWS][Shape<T, HD>::EPT], float (&m)[ROWS],
    float (&l)[ROWS], float (&acc)[ROWS][Shape<T, HD>::EPT]) {
  using S = Shape<T, HD>;
  constexpr int P = S::P, NV = S::NV, EPT = S::EPT, VEC = S::VEC;
  bool live[P];
  float s[ROWS][P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    live[p] = j0 + p * S::KPP + kg < j_end;
    float kf[EPT];
#pragma unroll
    for (int n = 0; n < NV; ++n) Elem<T>::unpack(kr[p][n], &kf[n * VEC]);
#pragma unroll
    for (int g = 0; g < ROWS; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < EPT; ++e) dot = fmaf(qr[g][e], kf[e], dot);
#pragma unroll
      for (int off = S::TPK / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      s[g][p] = dot * scale;
    }
  }
#pragma unroll
  for (int g = 0; g < ROWS; ++g) {
    float mx = m[g];
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (live[p]) mx = fmaxf(mx, s[g][p]);
    const float corr = expf(m[g] - mx);  // 1 when the max is unchanged
    m[g] = mx;
    l[g] *= corr;
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[g][e] *= corr;
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float vf[EPT];
#pragma unroll
    for (int n = 0; n < NV; ++n) Elem<T>::unpack(vr[p][n], &vf[n * VEC]);
#pragma unroll
    for (int g = 0; g < ROWS; ++g) {
      const float pe = live[p] ? expf(s[g][p] - m[g]) : 0.f;
      l[g] += pe;
      const float pr = Elem<T>::round(pe);  // p in v's dtype for PV
#pragma unroll
      for (int e = 0; e < EPT; ++e) acc[g][e] = fmaf(pr, vf[e], acc[g][e]);
    }
  }
}

// One or two query rows fit 128 registers a thread, so 512 / kThreads
// blocks share an SM; more rows get the registers of a whole SM.
template <typename T, int HD, int ROWS>
__global__ void __launch_bounds__(kThreads, ROWS <= 2 ? 512 / kThreads : 1)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out,
                        float* __restrict__ lse, int t, int kv, int group,
                        int chunks, int n_valid,
                        const int* __restrict__ n_valid_at, float scale) {
  using S = Shape<T, HD>;
  using Raw = typename Elem<T>::Raw;
  constexpr int VEC = S::VEC, TPK = S::TPK, NV = S::NV, EPT = S::EPT;
  constexpr int P = S::P, UNIT = S::UNIT;
  // Rows a pass of the block merge: s_red holds at most 32 KB.
  constexpr int RCH = ROWS < 8192 / (kWarps * HD) ? ROWS : 8192 / (kWarps * HD);

  __shared__ float s_wm[kWarps][ROWS];  // each warp's max of each row
  __shared__ float s_wl[kWarps][ROWS];  // each warp's l, at the block max
  __shared__ float s_red[kWarps][RCH][HD];
  // The block's partial, read by block rank 0 of the cluster.
  __shared__ float s_m[ROWS];
  __shared__ float s_l[ROWS];
  __shared__ float s_acc[ROWS][HD];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int splits = gridDim.x;  // one cluster spans grid x
  const int kvi = blockIdx.y / chunks;
  const int row0 = (blockIdx.y % chunks) * ROWS;
  const int bi = blockIdx.z;
  const int rows = min(ROWS, group - row0);
  const int tid = threadIdx.x;
  const int sub = tid % TPK;  // which 16-byte pieces of a key row
  const int kg = tid / TPK;   // which key group
  const int warp = tid / 32;
  const int lane = tid % 32;

  const int nv = n_valid_at ? *n_valid_at : n_valid;
  const int n_live = nv < 0 ? 0 : (nv >= t ? t : nv + 1);
  const int j_begin = static_cast<int>(static_cast<long long>(split) * t /
                                       splits);
  const int j_end = min(n_live, static_cast<int>(
                                    static_cast<long long>(split + 1) * t /
                                    splits));

  // Query rows of this block: heads kvi * group + row0 + g.
  const size_t head0 = ((size_t)bi * kv + kvi) * group + row0;
  float qr[ROWS][EPT];
  float acc[ROWS][EPT];
  float m[ROWS], l[ROWS];
#pragma unroll
  for (int g = 0; g < ROWS; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      qr[g][e] = 0.f;
      acc[g][e] = 0.f;
    }
    if (g < rows) {
#pragma unroll
      for (int n = 0; n < NV; ++n)
        Elem<T>::unpack(*reinterpret_cast<const Raw*>(
                            q + (head0 + g) * HD + (n * TPK + sub) * VEC),
                        &qr[g][n * VEC]);
    }
  }

  const size_t row_stride = (size_t)kv * HD;  // one cache position
  const T* kbase = k + ((size_t)bi * t * kv + kvi) * HD + sub * VEC;
  const T* vbase = v + ((size_t)bi * t * kv + kvi) * HD + sub * VEC;

  // Batches in pairs, two register sets: the loads of the next batch are
  // in flight while the current one is used.
  const int batches = j_end > j_begin ? (j_end - j_begin + UNIT - 1) / UNIT
                                      : 0;
  Raw ka[P][NV], va[P][NV], kb[P][NV], vb[P][NV];
  if (batches > 0)
    load_batch<T, HD>(kbase, vbase, row_stride, j_begin, j_end, kg, ka, va);
  for (int i = 0; i < batches; i += 2) {
    const int j0 = j_begin + i * UNIT;
    if (i + 1 < batches)
      load_batch<T, HD>(kbase, vbase, row_stride, j0 + UNIT, j_end, kg, kb,
                        vb);
    update<T, HD, ROWS>(ka, va, j0, j_end, kg, scale, qr, m, l, acc);
    if (i + 1 < batches) {
      if (i + 2 < batches)
        load_batch<T, HD>(kbase, vbase, row_stride, j0 + 2 * UNIT, j_end, kg,
                          ka, va);
      update<T, HD, ROWS>(kb, vb, j0 + UNIT, j_end, kg, scale, qr, m, l, acc);
    }
  }

  // The block's max of each row.
#pragma unroll
  for (int g = 0; g < ROWS; ++g) {
    float mx = m[g];
#pragma unroll
    for (int off = TPK; off < 32; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) s_wm[warp][g] = mx;
  }
  __syncthreads();
  // Each key group rescaled to it, then summed over the warp's key groups.
#pragma unroll
  for (int g = 0; g < ROWS; ++g) {
    float mb = s_wm[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mb = fmaxf(mb, s_wm[w][g]);
    const float c = expf(m[g] - mb);
    float lg = l[g] * c;
#pragma unroll
    for (int off = TPK; off < 32; off <<= 1)
      lg += __shfl_xor_sync(0xffffffffu, lg, off);
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      float a = acc[g][e] * c;
#pragma unroll
      for (int off = TPK; off < 32; off <<= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      acc[g][e] = a;
    }
    if (lane == 0) s_wl[warp][g] = lg;
  }
  // ...then over the warps, in warp order, RCH rows a pass.
#pragma unroll
  for (int g0 = 0; g0 < ROWS; g0 += RCH) {
    if (g0 > 0) __syncthreads();  // s_red is rewritten
    if (lane < TPK) {
#pragma unroll
      for (int g = 0; g < RCH; ++g)
#pragma unroll
        for (int n = 0; n < NV; ++n)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            s_red[warp][g][(n * TPK + sub) * VEC + e] =
                acc[g0 + g][n * VEC + e];
    }
    __syncthreads();
    for (int i = tid; i < RCH * HD; i += kThreads) {
      const int g = i / HD, d = i % HD;
      float a = s_red[0][g][d];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) a += s_red[w][g][d];
      s_acc[g0 + g][d] = a;
    }
  }
  if (tid < ROWS) {
    float mb = s_wm[0][tid], lb = s_wl[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      mb = fmaxf(mb, s_wm[w][tid]);
      lb += s_wl[w][tid];
    }
    s_m[tid] = mb;
    s_l[tid] = lb;
  }

  // The cluster's partials, merged by block rank 0 in rank order.
  cluster.sync();
  if (split == 0) {
    for (int i = tid; i < rows * HD; i += kThreads) {
      const int g = i / HD, d = i % HD;
      // Every rank's (m, l, acc) loads issued together; ranks past the
      // cluster are empty partials and change nothing.
      float ms[kMaxSplits], ls[kMaxSplits], as[kMaxSplits];
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        ms[r] = r < splits ? *cluster.map_shared_rank(&s_m[g], r) : kNegInf;
        ls[r] = r < splits ? *cluster.map_shared_rank(&s_l[g], r) : 0.f;
        as[r] = r < splits ? *cluster.map_shared_rank(&s_acc[g][d], r) : 0.f;
      }
      float mx = ms[0];
#pragma unroll
      for (int r = 1; r < kMaxSplits; ++r) mx = fmaxf(mx, ms[r]);
      float lt = 0.f, a = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        const float w = expf(ms[r] - mx);
        lt = fmaf(ls[r], w, lt);
        a = fmaf(as[r], w, a);
      }
      lt = fmaxf(lt, 1e-30f);
      out[(head0 + g) * HD + d] = Elem<T>::to_out(a / lt);
      if (d == 0) lse[head0 + g] = mx + logf(lt);
    }
  }
  cluster.sync();  // no block leaves while rank 0 reads its partial
}

template <typename T, int HD, int ROWS>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int b, int t, int kv, int h, int splits, int n_valid,
           const int* n_valid_at, float scale, cudaStream_t stream) {
  const int group = h / kv;
  const int chunks = (group + ROWS - 1) / ROWS;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  const dim3 grid(splits, kv * chunks, b);
  if (splits == 1) {  // a block is a cluster of its own: no attribute
    decode_attention_kernel<T, HD, ROWS><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out),
        static_cast<float*>(lse), t, kv, group, chunks, n_valid, n_valid_at,
        scale);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  config.attrs = &cluster;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &config, decode_attention_kernel<T, HD, ROWS>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), t, kv, group, chunks, n_valid, n_valid_at,
      scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int by_rows(const void* q, const void* k, const void* v, void* out, void* lse,
            int b, int t, int kv, int h, int splits, int n_valid,
            const int* n_valid_at, float scale, cudaStream_t stream) {
  const int group = h / kv;
  if (group == 1)
    return launch<T, HD, 1>(q, k, v, out, lse, b, t, kv, h, splits, n_valid,
                            n_valid_at, scale, stream);
  if (group == 2)
    return launch<T, HD, 2>(q, k, v, out, lse, b, t, kv, h, splits, n_valid,
                            n_valid_at, scale, stream);
  if (group <= 4)
    return launch<T, HD, 4>(q, k, v, out, lse, b, t, kv, h, splits, n_valid,
                            n_valid_at, scale, stream);
  return launch<T, HD, kMaxRows>(q, k, v, out, lse, b, t, kv, h, splits,
                                 n_valid, n_valid_at, scale, stream);
}

template <typename T>
int by_head_dim(const void* q, const void* k, const void* v, void* out,
                void* lse, int b, int t, int kv, int h, int hd, int splits,
                int n_valid, const int* n_valid_at, float scale,
                cudaStream_t stream) {
  switch (hd) {
    case 64: return by_rows<T, 64>(q, k, v, out, lse, b, t, kv, h, splits, n_valid, n_valid_at, scale, stream);
    case 128: return by_rows<T, 128>(q, k, v, out, lse, b, t, kv, h, splits, n_valid, n_valid_at, scale, stream);
    case 256: return by_rows<T, 256>(q, k, v, out, lse, b, t, kv, h, splits, n_valid, n_valid_at, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int unit_of(int hd) {
  switch (hd) {
    case 64: return Shape<T, 64>::UNIT;
    case 128: return Shape<T, 128>::UNIT;
    case 256: return Shape<T, 256>::UNIT;
    default: return 0;
  }
}

}  // namespace

extern "C" {

// q (b, h, hd), k/v (b, t, kv, hd), out (b, h, hd) in one dtype (float32
// when is_bf16 == 0, else bfloat16), lse (b, h) float32; all contiguous and
// 16-byte aligned; hd in {64, 128, 256}; 1 <= splits <= 8 blocks per
// cluster. The query's position is *n_valid_at (an int32 in device memory)
// when n_valid_at is not null, else n_valid; columns 0 .. position are
// live. Returns the CUDA error code of the launch (0 on success).
int decode_attention(const void* q, const void* k, const void* v, void* out,
                     void* lse, int b, int t, int kv, int h, int hd,
                     int splits, int n_valid, const void* n_valid_at,
                     float scale, int is_bf16, void* stream) {
  if (splits < 1 || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* at = static_cast<const int*>(n_valid_at);
  if (is_bf16)
    return by_head_dim<__nv_bfloat16>(q, k, v, out, lse, b, t, kv, h, hd,
                                      splits, n_valid, at, scale, s);
  return by_head_dim<float>(q, k, v, out, lse, b, t, kv, h, hd, splits,
                            n_valid, at, scale, s);
}

// Keys per batch of one block (its load unit) for this head_dim and dtype
// (0 if the kernel does not take the head_dim).
int decode_attention_tile(int hd, int is_bf16) {
  return is_bf16 ? unit_of<__nv_bfloat16>(hd) : unit_of<float>(hd);
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
