// Flash-decode attention for Hopper (sm_90a): one query position per
// (batch, head) against the KV cache, read in place in its storage layout
// (b, t, kv, hd).
//
// Replaces the TPU kernel mpi_tpu/ops/decode_attention.py:_decode_kernel
// (launched by flash_decode_attention there). Same function and edge
// semantics: columns 0 .. n_valid are live, inputs stay in their stored
// dtype, the softmax state (m, l, acc) is float32, p is rounded to v's
// dtype before the PV product, and an empty live prefix (n_valid < 0)
// gives a zero output with lse = m + log(1e-30) ~ -1e30.
//
// What bounds it on this card: bytes. Each live K and V row is read once
// and does 2 * hd FLOPs per query row against 2 * hd * sizeof(T) bytes, so
// with a GQA group of g rows the kernel does about g / sizeof(T) FLOPs per
// byte, far below the ~295 FLOPs per byte where an H100's tensor cores
// become the limit. The design therefore only has to read K and V once,
// with many wide loads in flight, and keep everything else on chip:
//   * one thread block per (b, kv head, chunk of up to 8 group rows), so
//     the group's query rows share every K/V load; the row count is a
//     template parameter (1, 2, 4 or 8), so a small group holds no unused
//     query or accumulator registers;
//   * neighbouring threads load neighbouring 16-byte pieces of one key row
//     (hd / VEC threads per key), so a warp reads whole rows;
//   * an in-block loop over tiles of keys takes the place of the TPU's
//     sequential third grid axis. A tile is kPasses keys per thread: each
//     thread issues all its K loads of the tile before it uses any, and its
//     V loads before the softmax update, so a tile costs about one memory
//     round trip for K and one, overlapped with the softmax, for V. The
//     loop stops at the live prefix, so dead cache columns are never read;
//   * QK dot products and the PV accumulation are float32 FMAs on the CUDA
//     cores: at g rows per key there is nothing for the tensor cores to do.
// Not done yet: splitting the key range across blocks with an lse merge.
// With one block per (b, kv) a batch of 8 with 8 kv heads fills 64 of the
// 132 SMs, and the tiles of one block run one after another.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPasses = 8;  // keys per thread per tile
constexpr int kMaxRows = 8;
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

// Work split of one block for element type T and head_dim HD.
template <typename T, int HD>
struct Shape {
  static constexpr int VEC = Elem<T>::kVec;
  static constexpr int TPK = (HD / VEC < 32) ? HD / VEC : 32;  // threads/key
  static constexpr int NV = HD / (VEC * TPK);  // 16-byte pieces per thread
  static constexpr int EPT = NV * VEC;         // elements per thread per key
  static constexpr int KPP = kThreads / TPK;   // keys per pass
  static constexpr int TILE = KPP * kPasses;   // keys per tile
  static_assert(HD % (VEC * TPK) == 0, "unsupported head_dim");
};

template <typename T, int HD, int ROWS>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out,
                        float* __restrict__ lse, int t, int kv, int group,
                        int n_live, float scale) {
  using S = Shape<T, HD>;
  using Raw = typename Elem<T>::Raw;
  constexpr int VEC = S::VEC, TPK = S::TPK, NV = S::NV, EPT = S::EPT;
  constexpr int KPP = S::KPP, TILE = S::TILE;

  __shared__ float s_p[ROWS][TILE];  // scores, then p rounded to T
  __shared__ float s_m[ROWS];
  __shared__ float s_l[ROWS];
  __shared__ float s_corr[ROWS];
  __shared__ float s_red[KPP][HD];

  const int kvi = blockIdx.x;
  const int bi = blockIdx.y;
  const int row0 = blockIdx.z * ROWS;
  const int rows = min(ROWS, group - row0);
  const int h = kv * group;
  const int tid = threadIdx.x;
  const int sub = tid % TPK;  // which 16-byte pieces of a key row
  const int kg = tid / TPK;   // which key of a pass
  const int warp = tid / 32;
  const int lane = tid % 32;

  // Query rows of this block: heads kvi * group + row0 + g.
  const size_t head0 = (size_t)bi * h + (size_t)kvi * group + row0;
  float qr[ROWS][EPT];
  float acc[ROWS][EPT];
#pragma unroll
  for (int g = 0; g < ROWS; ++g) {
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
  if (tid < ROWS) {
    s_m[tid] = kNegInf;
    s_l[tid] = 0.f;
    s_corr[tid] = 1.f;
  }

  const size_t row_stride = (size_t)kv * HD;  // one cache position
  const T* kbase = k + ((size_t)bi * t * kv + kvi) * HD + sub * VEC;
  const T* vbase = v + ((size_t)bi * t * kv + kvi) * HD + sub * VEC;

  for (int tile0 = 0; tile0 < n_live; tile0 += TILE) {
    // All K loads of the tile in flight at once.
    Raw raw[kPasses][NV];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int j = tile0 + p * KPP + kg;
#pragma unroll
      for (int n = 0; n < NV; ++n)
        raw[p][n] = j < n_live ? *reinterpret_cast<const Raw*>(
                                     kbase + j * row_stride + n * TPK * VEC)
                               : Raw{};
    }
    // Scores of the tile's keys for every row.
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int jl = p * KPP + kg;
      float kf[EPT];
#pragma unroll
      for (int n = 0; n < NV; ++n) Elem<T>::unpack(raw[p][n], &kf[n * VEC]);
#pragma unroll
      for (int g = 0; g < ROWS; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPT; ++e) dot = fmaf(qr[g][e], kf[e], dot);
#pragma unroll
        for (int off = TPK / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (sub == 0)
          s_p[g][jl] = (tile0 + jl < n_live) ? dot * scale : kNegInf;
      }
    }
    // V loads of the tile, in flight while the softmax state updates.
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int j = tile0 + p * KPP + kg;
#pragma unroll
      for (int n = 0; n < NV; ++n)
        raw[p][n] = j < n_live ? *reinterpret_cast<const Raw*>(
                                     vbase + j * row_stride + n * TPK * VEC)
                               : Raw{};
    }
    __syncthreads();

    // Online-softmax update, one warp per row.
    for (int g = warp; g < rows; g += kThreads / 32) {
      float mx = kNegInf;
      for (int c = lane; c < TILE; c += 32) mx = fmaxf(mx, s_p[g][c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < TILE; c += 32) {
        const float pe = expf(s_p[g][c] - m_new);
        sum += pe;
        s_p[g][c] = Elem<T>::round(pe);  // p in v's dtype for PV
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        s_l[g] = s_l[g] * corr + sum;
        s_m[g] = m_new;
        s_corr[g] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ V over this thread's keys and hd pieces. Dead
    // keys have p = 0 and V loaded as zeros.
#pragma unroll
    for (int g = 0; g < ROWS; ++g) {
      const float corr = s_corr[g];
#pragma unroll
      for (int e = 0; e < EPT; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int jl = p * KPP + kg;
      float vf[EPT];
#pragma unroll
      for (int n = 0; n < NV; ++n) Elem<T>::unpack(raw[p][n], &vf[n * VEC]);
#pragma unroll
      for (int g = 0; g < ROWS; ++g) {
        const float pg = s_p[g][jl];
#pragma unroll
        for (int e = 0; e < EPT; ++e) acc[g][e] = fmaf(pg, vf[e], acc[g][e]);
      }
    }
    __syncthreads();  // s_p is rewritten by the next tile
  }

  // Sum the per-key-group partial accumulators, normalise, write out.
#pragma unroll
  for (int g = 0; g < ROWS; ++g) {
    if (g < rows) {  // uniform across the block
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          s_red[kg][(n * TPK + sub) * VEC + e] = acc[g][n * VEC + e];
      __syncthreads();
      const float l = fmaxf(s_l[g], 1e-30f);
      for (int d = tid; d < HD; d += kThreads) {
        float a = 0.f;
#pragma unroll
        for (int r = 0; r < KPP; ++r) a += s_red[r][d];
        out[(head0 + g) * HD + d] = Elem<T>::to_out(a / l);
      }
      if (tid == 0) lse[head0 + g] = s_m[g] + logf(l);
      __syncthreads();
    }
  }
}

template <typename T, int HD, int ROWS>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int b, int t, int kv, int h, int n_live, float scale,
           cudaStream_t stream) {
  const int group = h / kv;
  const dim3 grid(kv, b, (group + ROWS - 1) / ROWS);
  decode_attention_kernel<T, HD, ROWS><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), t, kv, group, n_live, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int by_rows(const void* q, const void* k, const void* v, void* out, void* lse,
            int b, int t, int kv, int h, int n_live, float scale,
            cudaStream_t stream) {
  const int group = h / kv;
  if (group == 1)
    return launch<T, HD, 1>(q, k, v, out, lse, b, t, kv, h, n_live, scale, stream);
  if (group == 2)
    return launch<T, HD, 2>(q, k, v, out, lse, b, t, kv, h, n_live, scale, stream);
  if (group <= 4)
    return launch<T, HD, 4>(q, k, v, out, lse, b, t, kv, h, n_live, scale, stream);
  return launch<T, HD, kMaxRows>(q, k, v, out, lse, b, t, kv, h, n_live, scale,
                                 stream);
}

template <typename T>
int by_head_dim(const void* q, const void* k, const void* v, void* out,
                void* lse, int b, int t, int kv, int h, int hd, int n_live,
                float scale, cudaStream_t stream) {
  switch (hd) {
    case 64: return by_rows<T, 64>(q, k, v, out, lse, b, t, kv, h, n_live, scale, stream);
    case 128: return by_rows<T, 128>(q, k, v, out, lse, b, t, kv, h, n_live, scale, stream);
    case 256: return by_rows<T, 256>(q, k, v, out, lse, b, t, kv, h, n_live, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int tile_of(int hd) {
  switch (hd) {
    case 64: return Shape<T, 64>::TILE;
    case 128: return Shape<T, 128>::TILE;
    case 256: return Shape<T, 256>::TILE;
    default: return 0;
  }
}

}  // namespace

extern "C" {

// q (b, h, hd), k/v (b, t, kv, hd), out (b, h, hd) in one dtype (float32
// when is_bf16 == 0, else bfloat16), lse (b, h) float32; all contiguous and
// 16-byte aligned; hd in {64, 128, 256}. n_live = number of live cache
// columns (0 .. t). Returns the CUDA error code of the launch (0 on
// success).
int decode_attention(const void* q, const void* k, const void* v, void* out,
                     void* lse, int b, int t, int kv, int h, int hd,
                     int n_live, float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return by_head_dim<__nv_bfloat16>(q, k, v, out, lse, b, t, kv, h, hd,
                                      n_live, scale, s);
  return by_head_dim<float>(q, k, v, out, lse, b, t, kv, h, hd, n_live, scale,
                            s);
}

// Keys per tile of the kernel for this head_dim and dtype (0 if the kernel
// does not take the head_dim).
int decode_attention_tile(int hd, int is_bf16) {
  return is_bf16 ? tile_of<__nv_bfloat16>(hd) : tile_of<float>(hd);
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
