// Ring collectives for Hopper (sm_90a) over the ranks of a mesh on one
// device: kernel 5, the ring all-gather, and kernel 6, the all-reduce.
//
// Kernel 5, allgather_kernel, replaces mpi_tpu/ops/ring_collectives.py:
// _allgather_kernel. Kernel 6, allreduce_kernel, replaces _allreduce_kernel.
// On the TPU each device runs its own copy of the kernel and pushes a chunk
// into its ring neighbour's VMEM with a remote DMA, waiting on a DMA
// semaphore before the next hop. Here every rank's buffers lie on one card,
// and ONE launch runs the whole collective for all ranks. The kernels take
// a table of per-rank pointers (each rank's input and output), not a base
// address and a stride, so a rank's data is reached through a pointer, as a
// peer's would be over NVLink.
//
// Kernel 5 does NOT replay the TPU kernel's hops. The ring moves each
// chunk from rank to rank, n - 1 hops each reading what the last one wrote;
// but every hop only copies, so what rank r ends with at chunk c is x[c],
// whatever the route. So one pass gives the same bits: an ordinary
// grid-stride launch in which each thread loads unit i of rank c's input
// once (batches of kBatch loads in flight) and stores it at out[r] + c *
// chunk + i for every rank r. No barrier and no cooperative launch.
//
// Kernel 6 does NOT follow the TPU kernel's schedule, but gives its bits.
// The TPU ring all-reduce is a reduce-scatter of n - 1 hops (in hop t rank r
// folds out[r][c] = out[r][c] (+) out[r - 1][c] at c = (r - t - 1) mod n,
// local operand first, rounded to the working type as it is stored), then
// an all-gather of the reduced chunks. Following one output chunk c through
// those hops: rank c + 1 starts it as x[c + 1] (+) x[c]; rank c + 2 folds
// x[c + 2] (+) that; ... rank c + n - 1 = c - 1 finishes it as
//   acc = x[c + n - 1] (+) (... (+) (x[c + 1] (+) x[c])),  indices mod n,
// and the all-gather copies acc unchanged to every rank. So a single pass
// gives the same bits: for each element at offset e of chunk c, one thread
// loads x[k][c chunk + e] for every rank k (batches of 8 loads in flight),
// folds acc = x[c]; acc = x[(c + k) mod n] (+) acc for k = 1 .. n - 1,
// local first and rounded to T at every step, and stores acc to out[r] at
// chunk c for every rank r. Each element's n reads come before its n
// writes in one thread, and no thread touches another's elements, so an
// output may alias an input. There is no barrier and no cooperative launch:
// an ordinary grid-stride launch over n chunks of units.
//
// Arithmetic: the result is rounded to the working type after every fold
// (bf16 by __float2bfloat16_rn of the float result), as the TPU kernel
// rounds when it stores; a float32 partial is never carried across folds.
// max and min propagate NaN, as jnp.maximum and torch.maximum do (fmaxf and
// fminf would not); sum and prod use __fadd_rn / __fmul_rn, which are never
// contracted.
//
// What bounds them on this card: memory. The least traffic of an all-reduce
// is every input read once and every output written once, 2 n m elements
// for n ranks of m, and that is exactly what kernel 6 moves (the ring moved
// 2 n m + 5 (n - 1) m, 3.2 times as much at n = 8). The least traffic of
// an all-gather of chunks of c is n c + n^2 c, and that is what kernel 5
// moves (the ring moved 2 n c + 2 n (n - 1) c, 1.8 times as much at n = 8).
// Its writes are n times its reads, so the stores set its pace. Both
// take 16-byte loads and stores wherever every chunk and every rank's
// buffer is 16-byte aligned (checked at each launch; element-wide
// otherwise, so a chunk of 24 bytes works).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRanks = 64;
constexpr int kThreads = 256;

enum Op { kSum = 0, kMax = 1, kMin = 2, kProd = 3 };

// The per-rank pointer table, passed by value (1 KB of kernel parameters).
struct Ranks {
  const void* in[kMaxRanks];
  void* out[kMaxRanks];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int OP>
__device__ __forceinline__ float combine(float a, float b) {
  if (OP == kSum) return __fadd_rn(a, b);
  if (OP == kProd) return __fmul_rn(a, b);
  if (a != a) return a;  // NaN propagates, local first
  if (b != b) return b;
  if (OP == kMax) return a < b ? b : a;
  return b < a ? b : a;  // kMin
}

// local (+) arriving, rounded to T: one element...
template <typename T, int OP>
__device__ __forceinline__ T fold(T a, T b) {
  return from_float<T>(combine<OP>(to_float(a), to_float(b)));
}
// ...or the elements of T in 16 bytes.
template <typename T, int OP>
__device__ __forceinline__ uint4 fold(uint4 a, uint4 b) {
  T* pa = reinterpret_cast<T*>(&a);
  const T* pb = reinterpret_cast<const T*>(&b);
#pragma unroll
  for (int i = 0; i < static_cast<int>(16 / sizeof(T)); ++i)
    pa[i] = fold<T, OP>(pa[i], pb[i]);
  return a;
}

// ---- kernel 6: single-pass all-reduce ------------------------------------
//
// T is the element type, V the unit moved (T, or uint4 for 16 bytes of T);
// chunk is the length of one chunk in units of V. Each thread takes offsets
// e, e + stride, ... of every chunk c.

constexpr int kBatch = 8;  // loads in flight per thread

template <typename T, int OP, typename V>
__global__ void __launch_bounds__(kThreads)
allreduce_kernel(const Ranks ranks, int n, long long chunk) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (int c = 0; c < n; ++c) {
    for (long long i = c * chunk + static_cast<long long>(blockIdx.x) *
                                       blockDim.x + threadIdx.x;
         i < (c + 1) * chunk; i += stride) {
      V acc;
      for (int k0 = 0; k0 < n; k0 += kBatch) {
        V x[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (k0 + b < n) {
            const int r = c + k0 + b;  // < 2 n
            x[b] = static_cast<const V*>(ranks.in[r < n ? r : r - n])[i];
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (k0 + b < n) acc = k0 + b == 0 ? x[b] : fold<T, OP>(x[b], acc);
        }
      }
      for (int r = 0; r < n; ++r) static_cast<V*>(ranks.out[r])[i] = acc;
    }
  }
}

// ---- kernel 5: single-pass all-gather ------------------------------------
//
// V is the unit moved (a 2- or 4-byte element, or uint4); rank c's input is
// one chunk of `chunk` units, every rank's output n chunks. The stores are
// st.global.cs (evict first): no output is read again by this launch.

template <typename V>
__global__ void __launch_bounds__(kThreads)
allgather_kernel(const Ranks ranks, int n, long long chunk) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int c = 0; c < n; ++c) {
    const V* x = static_cast<const V*>(ranks.in[c]);
    for (long long i0 = tid; i0 < chunk; i0 += kBatch * stride) {
      V u[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const long long i = i0 + b * stride;
        if (i < chunk) u[b] = x[i];
      }
      for (int r = 0; r < n; ++r) {
        V* o = static_cast<V*>(ranks.out[r]) + c * chunk;
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const long long i = i0 + b * stride;
          if (i < chunk) __stcs(o + i, u[b]);
        }
      }
    }
  }
}

// As many blocks of `kern` as `units` need, one unit a thread, capped at
// the blocks that can be resident on the card at once.
template <typename K>
cudaError_t resident_grid(K kern, long long units, dim3* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long want = (units + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms) * per_sm;
  *grid = dim3(static_cast<unsigned>(want < 1 ? 1 : (want < most ? want
                                                                 : most)));
  return cudaSuccess;
}

// One ordinary launch of kernel 6, sized by one chunk's units (the
// grid-stride loop takes every chunk).
template <typename T, int OP, typename V>
int launch_allreduce(const Ranks& ranks, int n, long long chunk,
                     cudaStream_t stream) {
  auto kern = allreduce_kernel<T, OP, V>;
  dim3 grid;
  cudaError_t err = resident_grid(kern, chunk, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, kThreads, 0, stream>>>(ranks, n, chunk);
  return static_cast<int>(cudaGetLastError());
}

// One ordinary launch of kernel 5, sized by one chunk's units.
template <typename V>
int launch_allgather(const Ranks& ranks, int n, long long chunk,
                     cudaStream_t stream) {
  auto kern = allgather_kernel<V>;
  dim3 grid;
  cudaError_t err = resident_grid(kern, chunk, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, kThreads, 0, stream>>>(ranks, n, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int OP>
int allreduce_t(const Ranks& ranks, int n, long long chunk, bool vec,
                cudaStream_t stream) {
  if (vec)
    return launch_allreduce<T, OP, uint4>(
        ranks, n, chunk * static_cast<long long>(sizeof(T)) / 16, stream);
  return launch_allreduce<T, OP, T>(ranks, n, chunk, stream);
}

template <typename T>
int allreduce_op(const Ranks& ranks, int n, long long chunk, int op,
                 bool vec, cudaStream_t stream) {
  switch (op) {
    case kSum: return allreduce_t<T, kSum>(ranks, n, chunk, vec, stream);
    case kMax: return allreduce_t<T, kMax>(ranks, n, chunk, vec, stream);
    case kMin: return allreduce_t<T, kMin>(ranks, n, chunk, vec, stream);
    case kProd: return allreduce_t<T, kProd>(ranks, n, chunk, vec, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Whether every chunk of every rank starts on 16 bytes.
bool aligned16(const Ranks& ranks, int n, long long chunk_bytes) {
  if (chunk_bytes % 16) return false;
  for (int r = 0; r < n; ++r)
    if (reinterpret_cast<uintptr_t>(ranks.in[r]) % 16 ||
        reinterpret_cast<uintptr_t>(ranks.out[r]) % 16)
      return false;
  return true;
}

Ranks table(const void* const* in, void* const* out, int n) {
  Ranks ranks{};
  for (int r = 0; r < n; ++r) {
    ranks.in[r] = in[r];
    ranks.out[r] = out[r];
  }
  return ranks;
}

}  // namespace

extern "C" {

// Each function launches one kernel on `stream` and returns the CUDA error
// code of the launch (0 on success). `in` and `out` hold one device pointer
// per rank (n <= ring_collectives_max_ranks()); every buffer is contiguous.

int ring_collectives_max_ranks() { return kMaxRanks; }

// Kernel 6: rank r's n * chunk elements x[r] -> out[r], reduced over the
// ranks in the ring's fold order. is_bf16 selects bfloat16 (else float32);
// op: 0 sum, 1 max, 2 min, 3 prod.
int ring_allreduce(const void* const* in, void* const* out, int n,
                   long long chunk, int is_bf16, int op, void* stream) {
  if (n < 1 || n > kMaxRanks || chunk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (chunk == 0) return 0;
  const Ranks ranks = table(in, out, n);
  const auto s = static_cast<cudaStream_t>(stream);
  const long long elt = is_bf16 ? 2 : 4;
  const bool vec = aligned16(ranks, n, chunk * elt);
  if (is_bf16)
    return allreduce_op<__nv_bfloat16>(ranks, n, chunk, op, vec, s);
  return allreduce_op<float>(ranks, n, chunk, op, vec, s);
}

// Kernel 5: rank r's chunk of `chunk` elements of elt_size bytes (2 or 4)
// lands at chunk r of every rank's output of n chunks.
int ring_allgather(const void* const* in, void* const* out, int n,
                   long long chunk, int elt_size, void* stream) {
  if (n < 1 || n > kMaxRanks || chunk < 0 || (elt_size != 2 && elt_size != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (chunk == 0) return 0;
  const Ranks ranks = table(in, out, n);
  const auto s = static_cast<cudaStream_t>(stream);
  if (aligned16(ranks, n, chunk * elt_size))
    return launch_allgather<uint4>(ranks, n, chunk * elt_size / 16, s);
  if (elt_size == 2) return launch_allgather<uint16_t>(ranks, n, chunk, s);
  return launch_allgather<uint32_t>(ranks, n, chunk, s);
}

const char* ring_collectives_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
