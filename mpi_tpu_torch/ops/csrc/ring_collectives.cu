// Ring collectives for Hopper (sm_90a) over the ranks of a mesh on one
// device: kernel 5, the ring all-gather, and kernel 6, the ring all-reduce.
//
// Kernel 5, ring_allgather_kernel, replaces mpi_tpu/ops/ring_collectives.py:
// _allgather_kernel. Kernel 6, ring_allreduce_kernel, replaces
// _allreduce_kernel. On the TPU each device runs its own copy of the kernel
// and pushes a chunk into its ring neighbour's VMEM with a remote DMA,
// waiting on a DMA semaphore before the next hop. Here every rank's buffers
// lie on one card, and ONE cooperative launch runs the whole collective for
// all ranks:
//   * the kernel takes a table of per-rank pointers (each rank's input and
//     output), not a base address and a stride, so a rank reads its left
//     neighbour's output through a pointer, as it would read a peer's over
//     NVLink;
//   * a hop is a grid-stride pass over every rank's chunk, and a grid-wide
//     barrier (cooperative_groups::this_grid().sync(), which needs the
//     cooperative launch and a grid no larger than the blocks that can be
//     resident) takes the place of the semaphore wait between hops. No
//     block waits on a flag that another launch must set, so the kernel
//     cannot deadlock on ranks that are not resident together;
//   * instead of pushing, each rank PULLS the arriving chunk from its left
//     neighbour's output.
//
// All-reduce of per-rank buffers of n chunks (chunk c of rank r: out[r][c]):
//   copy:                  out[r] = x[r]
//   reduce-scatter hop t:  c = (r - t - 1) mod n,
//                          out[r][c] = out[r][c] (+) out[r - 1][c]
//   all-gather hop t:      c = (r - t) mod n,  out[r][c] = out[r - 1][c]
// for t = 0 .. n - 2, a barrier before each hop. This is the TPU kernel's
// schedule: there rank r - 1 sends its chunk (r - 1 - t) mod n, which is
// the chunk rank r folds in. No hop reads what it writes: in reduce-scatter
// hop t rank r reads out[r - 1] at chunk (r - t - 1) mod n, and rank r - 1
// writes only its own chunk (r - t - 2) mod n in that hop; in all-gather
// hop t rank r reads out[r - 1] at chunk (r - t) mod n while rank r - 1
// writes its chunk (r - t - 1) mod n. Both differ for n >= 2, and each
// element of a chunk is read and written by one thread, so a hop needs no
// barrier inside it. The all-gather is the same frame: out[r][r] = x[r],
// then in hop t rank r copies chunk (r - t - 1) mod n from out[r - 1],
// which rank r - 1 received in hop t - 1 (its own chunk for t = 0).
//
// Arithmetic: the operand order is local (+) arriving, and the result is
// rounded to the working type after every hop (bf16 by __float2bfloat16_rn
// of the float result), as the TPU kernel rounds when it stores. A float32
// partial is never carried across hops. max and min propagate NaN, as
// jnp.maximum and torch.maximum do (fmaxf and fminf would not); sum and
// prod use __fadd_rn / __fmul_rn, which are never contracted.
//
// What bounds them on this card: memory. The least traffic of an all-reduce
// is every input read once and every output written once, 2 n m elements
// for n ranks of m; this ring moves 2 n m (copy) + 3 (n - 1) m (each
// reduce-scatter hop reads two chunks and writes one per rank) + 2 (n - 1) m
// (all-gather), 51 m at n = 8, some 3.2 times the least. The all-gather
// moves 2 n c + 2 n (n - 1) c for chunks of c against a least of
// n c + n^2 c. What the design does about it: 16-byte loads and stores
// wherever every chunk and every rank's buffer is 16-byte aligned (checked
// at each launch; element-wide otherwise, so a chunk of 24 bytes works), and
// a grid of every block that can be resident. Not done yet: folding the
// copy into the first hop, and a schedule that moves only the least bytes
// (on one card, rank r could read all n inputs at once); on one device the
// ring's only merit is that it is the ring.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxRanks = 64;
constexpr int kThreads = 256;

enum Op { kSum = 0, kMax = 1, kMin = 2, kProd = 3 };

// The per-rank pointer table, passed by value (1 KB of kernel parameters).
struct Ranks {
  const void* in[kMaxRanks];
  void* out[kMaxRanks];
};

__device__ __forceinline__ int ring_mod(int a, int n) {
  return ((a % n) + n) % n;
}

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

// ---- kernel 6: ring all-reduce ------------------------------------------
//
// T is the element type, V the unit moved (T, or uint4 for 16 bytes of T);
// chunk is the length of one chunk in units of V.

template <typename T, int OP, typename V>
__global__ void __launch_bounds__(kThreads)
ring_allreduce_kernel(const Ranks ranks, int n, long long chunk) {
  cg::grid_group grid = cg::this_grid();
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long total = chunk * n;
  for (int r = 0; r < n; ++r) {
    const V* x = static_cast<const V*>(ranks.in[r]);
    V* o = static_cast<V*>(ranks.out[r]);
    for (long long i = tid; i < total; i += stride) o[i] = x[i];
  }
  for (int t = 0; t < n - 1; ++t) {  // reduce-scatter
    grid.sync();
    for (int r = 0; r < n; ++r) {
      const long long off = ring_mod(r - t - 1, n) * chunk;
      V* own = static_cast<V*>(ranks.out[r]) + off;
      const V* left = static_cast<const V*>(ranks.out[ring_mod(r - 1, n)]) +
                      off;
      for (long long i = tid; i < chunk; i += stride)
        own[i] = fold<T, OP>(own[i], left[i]);
    }
  }
  for (int t = 0; t < n - 1; ++t) {  // all-gather of the reduced chunks
    grid.sync();
    for (int r = 0; r < n; ++r) {
      const long long off = ring_mod(r - t, n) * chunk;
      V* own = static_cast<V*>(ranks.out[r]) + off;
      const V* left = static_cast<const V*>(ranks.out[ring_mod(r - 1, n)]) +
                      off;
      for (long long i = tid; i < chunk; i += stride) own[i] = left[i];
    }
  }
}

// ---- kernel 5: ring all-gather ------------------------------------------
//
// V is the unit moved (a 2- or 4-byte element, or uint4); rank r's input is
// one chunk, its output n chunks.

template <typename V>
__global__ void __launch_bounds__(kThreads)
ring_allgather_kernel(const Ranks ranks, int n, long long chunk) {
  cg::grid_group grid = cg::this_grid();
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (int r = 0; r < n; ++r) {
    const V* x = static_cast<const V*>(ranks.in[r]);
    V* o = static_cast<V*>(ranks.out[r]) + r * chunk;
    for (long long i = tid; i < chunk; i += stride) o[i] = x[i];
  }
  for (int t = 0; t < n - 1; ++t) {
    grid.sync();
    for (int r = 0; r < n; ++r) {
      const long long off = ring_mod(r - t - 1, n) * chunk;
      V* own = static_cast<V*>(ranks.out[r]) + off;
      const V* left = static_cast<const V*>(ranks.out[ring_mod(r - 1, n)]) +
                      off;
      for (long long i = tid; i < chunk; i += stride) own[i] = left[i];
    }
  }
}

// One cooperative launch of `kern` on `stream`: as many blocks as the work
// of one hop (`units` per rank) needs, capped at the blocks that can be
// resident at once, which grid.sync() requires.
template <typename K>
int launch_cooperative(K kern, const Ranks& ranks, int n, long long chunk,
                       long long units, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const long long want = (units + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms) * per_sm;
  const dim3 grid(static_cast<unsigned>(want < 1 ? 1 : (want < most ? want
                                                                    : most)));
  Ranks r = ranks;
  void* args[] = {&r, &n, &chunk};
  err = cudaLaunchCooperativeKernel((void*)kern, grid, dim3(kThreads), args,
                                    0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int OP>
int allreduce_t(const Ranks& ranks, int n, long long chunk, bool vec,
                cudaStream_t stream) {
  if (vec) {
    const long long c = chunk * static_cast<long long>(sizeof(T)) / 16;
    return launch_cooperative(ring_allreduce_kernel<T, OP, uint4>, ranks, n,
                              c, c, stream);
  }
  return launch_cooperative(ring_allreduce_kernel<T, OP, T>, ranks, n, chunk,
                            chunk, stream);
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
// ranks. is_bf16 selects bfloat16 (else float32); op: 0 sum, 1 max, 2 min,
// 3 prod.
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
  if (aligned16(ranks, n, chunk * elt_size)) {
    const long long c = chunk * elt_size / 16;
    return launch_cooperative(ring_allgather_kernel<uint4>, ranks, n, c, c,
                              s);
  }
  if (elt_size == 2)
    return launch_cooperative(ring_allgather_kernel<uint16_t>, ranks, n,
                              chunk, chunk, s);
  return launch_cooperative(ring_allgather_kernel<uint32_t>, ranks, n, chunk,
                            chunk, s);
}

const char* ring_collectives_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
