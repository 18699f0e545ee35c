// Static send/receive for Hopper (sm_90a) over the ranks of a mesh on one
// device: kernel 7.
//
// sendrecv_kernel replaces mpi_tpu/parallel/p2p.py: _sendrecv_kernel. On the
// TPU every device pushes its block into its destination's output with one
// remote DMA, a semaphore pair standing in for the rendezvous ack, and a
// rank outside the requested pattern masks its output to zeros. Here ONE
// launch moves every rank's block: out[d] = x[src[d]] for each receiver d
// of the pattern, zeros where src[d] < 0. The kernel takes a table of
// per-rank pointers, so a rank's block is read through a pointer as it
// would be read from a peer over NVLink. Each output element is written
// once and no output is read, so it needs no barrier. The pattern's checks
// (each rank sends at most once and receives at most once) stay with the
// caller, which builds src from them.
//
// What bounds it on this card: memory. It reads each sending block once
// and writes every block once, the least a permutation can move. The
// design: a grid-stride pass per rank, 16-byte loads and stores wherever
// every block is 16-byte aligned (element-wide otherwise).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRanks = 64;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8192;

struct Ranks {
  const void* in[kMaxRanks];
  void* out[kMaxRanks];
  int src[kMaxRanks];  // sending rank of each receiver, -1: zeros
};

template <typename V>
__global__ void __launch_bounds__(kThreads)
sendrecv_kernel(const Ranks ranks, int n, long long block) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (int d = 0; d < n; ++d) {
    V* o = static_cast<V*>(ranks.out[d]);
    const int s = ranks.src[d];
    if (s >= 0) {
      const V* x = static_cast<const V*>(ranks.in[s]);
      for (long long i = tid; i < block; i += stride) o[i] = x[i];
    } else {
      const V zero{};
      for (long long i = tid; i < block; i += stride) o[i] = zero;
    }
  }
}

template <typename V>
int launch(const Ranks& ranks, int n, long long block, cudaStream_t stream) {
  long long blocks = (block + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  sendrecv_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      ranks, n, block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches kernel 7 on `stream` and returns the CUDA error code of the
// launch (0 on success). `in` and `out` hold one device pointer per rank
// and `src` each receiver's sending rank (-1 for zeros), n <=
// sendrecv_max_ranks(); every block is `block` contiguous elements of
// elt_size bytes (2 or 4).
int sendrecv(const void* const* in, void* const* out, const int* src, int n,
             long long block, int elt_size, void* stream) {
  if (n < 1 || n > kMaxRanks || block < 0 || (elt_size != 2 && elt_size != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (block == 0) return 0;
  Ranks ranks{};
  bool vec = block * elt_size % 16 == 0;
  for (int r = 0; r < n; ++r) {
    if (src[r] >= n) return static_cast<int>(cudaErrorInvalidValue);
    ranks.in[r] = in[r];
    ranks.out[r] = out[r];
    ranks.src[r] = src[r];
    vec = vec && reinterpret_cast<uintptr_t>(in[r]) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(out[r]) % 16 == 0;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec) return launch<uint4>(ranks, n, block * elt_size / 16, s);
  if (elt_size == 2) return launch<uint16_t>(ranks, n, block, s);
  return launch<uint32_t>(ranks, n, block, s);
}

int sendrecv_max_ranks() { return kMaxRanks; }

const char* sendrecv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
