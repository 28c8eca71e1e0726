// Native host-side crop gather for the training input pipeline (the port's
// copy of nsynth_wavenet_tpu/data/native/sampler.cpp, the same C interface).
//
// The loader memory-maps a flat float32 PCM file (data/dataset.py); the hot
// host-side step is gathering B crops of `crop_len` samples into one
// contiguous batch.  numpy does this with a per-record Python loop; this does
// the gather and the zero padding in C++, with a thread pool for large
// batches.  Record and start selection stays in seeded numpy, so the native
// and numpy gathers give the same bits (tests/test_torch_native_sampler.py).
//
// Built with g++ at first use by native.py into nsynth_wavenet_tpu_torch/_build/.
// No dependency beyond the C++17 standard library.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Gather crops: out[b, :] = data[offset[rec[b]] + start[b] : ... + crop_len],
// zero-padded past the record end (start[b] must be < length[rec[b]] or the
// record is all-padding when length == 0).  Records shorter than crop_len
// produce a tail of zeros, matching Dataset.random_crop_batch.
//
// data:      the whole mmap'd float32 PCM blob
// offsets:   per-record start offsets into `data` (n_records)
// lengths:   per-record lengths (n_records)
// rec_idx:   chosen record per batch row (batch)
// starts:    chosen crop start within the record per batch row (batch)
// out:       float32 [batch, crop_len], fully overwritten
// n_threads: 0 = single-threaded; else a pool of min(n_threads, batch)
void crop_gather(const float* data, const int64_t* offsets,
                 const int64_t* lengths, int64_t n_records,
                 const int64_t* rec_idx, const int64_t* starts, int64_t batch,
                 int64_t crop_len, float* out, int64_t n_threads) {
  auto fill_row = [&](int64_t b) {
    int64_t r = rec_idx[b];
    if (r < 0 || r >= n_records) {  // defensive: bad index -> silence
      std::memset(out + b * crop_len, 0, sizeof(float) * crop_len);
      return;
    }
    int64_t len = lengths[r];
    int64_t start = starts[b];
    if (start < 0) start = 0;
    int64_t avail = len > start ? len - start : 0;
    int64_t take = avail < crop_len ? avail : crop_len;
    const float* src = data + offsets[r] + start;
    float* dst = out + b * crop_len;
    if (take > 0) std::memcpy(dst, src, sizeof(float) * take);
    if (take < crop_len)
      std::memset(dst + take, 0, sizeof(float) * (crop_len - take));
  };

  if (n_threads <= 1 || batch <= 1) {
    for (int64_t b = 0; b < batch; ++b) fill_row(b);
    return;
  }
  int64_t nt = n_threads < batch ? n_threads : batch;
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int64_t t = 0; t < nt; ++t) {
    pool.emplace_back([&]() {
      for (int64_t b = next.fetch_add(1); b < batch; b = next.fetch_add(1))
        fill_row(b);
    });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
