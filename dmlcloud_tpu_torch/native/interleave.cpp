// Host-side native code of dmlcloud_tpu_torch (the port's own copy of the
// reference's native/interleave.cpp; the same symbol and layout contract).
//
// dmltpu_interleave: the inner loop of data.interleave_batches — re-slices
// num_batches consecutive batches into num_batches mixed batches through one
// preallocated buffer. Layout contract (matches the numpy fallback in
// data/datasets.py):
//
//   dst[i * batch_bytes + j * slice_bytes .. +slice_bytes]
//     = srcs[j][i * slice_bytes .. +slice_bytes]
//
// Pure memcpy, parallelised over the destination batches with std::thread —
// bandwidth-bound, no interpreter in the loop. Built at first use by
// native/_lib.py (g++ -O3 -fPIC -shared -std=c++17 -pthread).

#include <cstring>
#include <thread>
#include <vector>

extern "C" {

int dmltpu_interleave(void* dst_v, void** srcs_v, long num_batches,
                      long slice_bytes, long batch_bytes) {
  if (dst_v == nullptr || srcs_v == nullptr || num_batches <= 0 ||
      slice_bytes <= 0 || batch_bytes <= 0) {
    return 1;
  }
  char* dst = static_cast<char*>(dst_v);
  char** srcs = reinterpret_cast<char**>(srcs_v);

  auto copy_row = [&](long i) {
    char* out = dst + i * batch_bytes;
    for (long j = 0; j < num_batches; ++j) {
      std::memcpy(out + j * slice_bytes, srcs[j] + i * slice_bytes,
                  static_cast<size_t>(slice_bytes));
    }
  };

  // Small groups: threads cost more than they save.
  const long total_bytes = num_batches * batch_bytes;
  if (num_batches == 1 || total_bytes < (1L << 20)) {
    for (long i = 0; i < num_batches; ++i) copy_row(i);
    return 0;
  }

  unsigned hw = std::thread::hardware_concurrency();
  long n_threads = static_cast<long>(hw > 0 ? hw : 2);
  if (n_threads > num_batches) n_threads = num_batches;

  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(n_threads));
  for (long t = 0; t < n_threads; ++t) {
    threads.emplace_back([&, t]() {
      for (long i = t; i < num_batches; i += n_threads) copy_row(i);
    });
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
