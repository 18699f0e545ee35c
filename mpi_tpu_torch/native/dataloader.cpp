// dataloader — native batch-gather kernel for the port's data path.
//
// A copy of the JAX package's native/dataloader.cpp (dl_gather v1): the
// port keeps its own. The loader (mpi_tpu_torch/data.py) assembles each
// training batch by gathering `batch` windows of `seq` tokens out of a
// (typically memory-mapped) corpus and widening them to int32. In Python
// that is a per-window loop plus a stack copy under the GIL — exactly the
// work that should overlap with the previous step's device compute. This
// kernel does the whole gather+widen in one ctypes call with the GIL
// released, optionally fanned across threads (row-partitioned, no false
// sharing: each thread writes disjoint output rows).
//
// Token dtypes: u8, u16, u32/i32 (token_bytes = 1, 2, 4). u32 values
// above INT32_MAX wrap negative on widen — callers must validate their
// corpus ids against the model vocab (mpi_tpu_torch/train.py checks the
// corpus once before training); realistic vocabularies sit far below 2^31.
//
// Returns 0, or -EINVAL for bad arguments (out-of-range window index —
// checked up front so a bad index can never read past the corpus).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

template <typename T>
void gather_rows(const uint8_t *base, const int64_t *windows,
                 uint32_t row_begin, uint32_t row_end, uint32_t seq,
                 int32_t *out) {
  for (uint32_t b = row_begin; b < row_end; ++b) {
    const T *src = reinterpret_cast<const T *>(base) +
                   static_cast<uint64_t>(windows[b]) * seq;
    int32_t *dst = out + static_cast<uint64_t>(b) * seq;
    for (uint32_t i = 0; i < seq; ++i) dst[i] = static_cast<int32_t>(src[i]);
  }
}

void gather_span(const uint8_t *base, int token_bytes,
                 const int64_t *windows, uint32_t row_begin,
                 uint32_t row_end, uint32_t seq, int32_t *out) {
  switch (token_bytes) {
    case 1:
      gather_rows<uint8_t>(base, windows, row_begin, row_end, seq, out);
      break;
    case 2:
      gather_rows<uint16_t>(base, windows, row_begin, row_end, seq, out);
      break;
    case 4:
      // memcpy fast path: same width, reinterpret as int32
      for (uint32_t b = row_begin; b < row_end; ++b) {
        std::memcpy(out + static_cast<uint64_t>(b) * seq,
                    base + static_cast<uint64_t>(windows[b]) * seq * 4,
                    static_cast<uint64_t>(seq) * 4);
      }
      break;
  }
}

}  // namespace

extern "C" {

// Gather `batch` windows of `seq` tokens (window w = tokens
// [windows[b]*seq, (windows[b]+1)*seq)) from a corpus of `n_tokens`
// tokens of width `token_bytes`, widening into the int32 row-major
// output (batch, seq). `nthreads` <= 1 runs inline; otherwise rows are
// split across std::threads (use the physical core count — on a
// single-core host threads only add overhead).
int dl_gather(const uint8_t *base, uint64_t n_tokens, int token_bytes,
              const int64_t *windows, uint32_t batch, uint32_t seq,
              int32_t *out, int nthreads) {
  if (base == nullptr || windows == nullptr || out == nullptr)
    return -EINVAL;
  if (token_bytes != 1 && token_bytes != 2 && token_bytes != 4)
    return -EINVAL;
  if (seq == 0) return -EINVAL;
  const uint64_t n_windows = n_tokens / seq;
  for (uint32_t b = 0; b < batch; ++b) {
    if (windows[b] < 0 || static_cast<uint64_t>(windows[b]) >= n_windows)
      return -EINVAL;
  }
  if (nthreads <= 1 || batch < 2) {
    gather_span(base, token_bytes, windows, 0, batch, seq, out);
    return 0;
  }
  const uint32_t workers =
      static_cast<uint32_t>(nthreads) < batch ? nthreads : batch;
  std::vector<std::thread> threads;
  threads.reserve(workers);
  const uint32_t rows_per = (batch + workers - 1) / workers;
  for (uint32_t t = 0; t < workers; ++t) {
    uint32_t lo = t * rows_per;
    uint32_t hi = lo + rows_per < batch ? lo + rows_per : batch;
    if (lo >= hi) break;
    threads.emplace_back(gather_span, base, token_bytes, windows, lo, hi,
                         seq, out);
  }
  for (auto &th : threads) th.join();
  return 0;
}

int dl_version() { return 1; }

}  // extern "C"
