// The upload's host copy of a plane into its pinned staging block, on
// the calling thread and helper threads (utils/device.copy_in_bands).
//
// The plane is cut into bands of whole rows.  The calling thread and up
// to threads - 1 helpers claim bands in turn until none is left, so a
// helper that wakes late finds less work, or none, and the call never
// waits for a helper that has not started: it waits only for the bands
// already claimed.  Helpers sleep between copies (no spinning).  One
// copy runs at a time; a second caller waits for the first.
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <system_error>
#include <thread>

namespace {

struct Job {
  char* dst;
  const char* src;
  int64_t rows, row_bytes, dst_stride, src_stride, bands;
  int helpers;                       // helpers that may join
  std::atomic<int64_t> next{0};      // the next band to claim

  void band(int64_t i) {
    const int64_t a = rows * i / bands, b = rows * (i + 1) / bands;
    if (dst_stride == row_bytes && src_stride == row_bytes) {
      std::memcpy(dst + a * row_bytes, src + a * row_bytes,
                  (b - a) * row_bytes);
      return;
    }
    for (int64_t r = a; r < b; ++r)
      std::memcpy(dst + r * dst_stride, src + r * src_stride, row_bytes);
  }

  // copies bands until none is left
  void work() {
    for (int64_t i; (i = next.fetch_add(1)) < bands;) band(i);
  }
};

// Never destroyed: detached helpers may still wait on it at exit.
struct Pool {
  std::mutex calls;                  // one copy at a time
  std::mutex mu;                     // guards job, posted, started
  std::condition_variable wake;
  Job* job = nullptr;                // the job helpers may join
  uint64_t posted = 0;               // jobs posted so far
  int started = 0;                   // helper threads started
  std::atomic<int> joined{0};        // helpers inside `job`

  void helper() {
    uint64_t seen = 0;
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      wake.wait(lk, [&] { return posted != seen; });
      seen = posted;
      Job* j = job;
      if (j == nullptr || j->helpers == 0) continue;
      --j->helpers;
      joined.fetch_add(1);
      lk.unlock();
      j->work();
      joined.fetch_sub(1, std::memory_order_release);
      lk.lock();
    }
  }
};

Pool& pool() {
  static Pool* p = new Pool;
  return *p;
}

}  // namespace

// Copies `rows` rows of `row_bytes` bytes, row r from src + r*src_stride
// to dst + r*dst_stride, in `bands` bands on the calling thread and up to
// threads - 1 helpers.
extern "C" void pl_copy_rows(void* dst, const void* src, int64_t rows,
                            int64_t row_bytes, int64_t dst_stride,
                            int64_t src_stride, int threads, int64_t bands) {
  Pool& p = pool();
  std::lock_guard<std::mutex> one(p.calls);
  Job j;
  j.dst = static_cast<char*>(dst);
  j.src = static_cast<const char*>(src);
  j.rows = rows;
  j.row_bytes = row_bytes;
  j.dst_stride = dst_stride;
  j.src_stride = src_stride;
  j.bands = bands;
  j.helpers = threads - 1;
  {
    std::lock_guard<std::mutex> lk(p.mu);
    // a thread the system refuses leaves fewer helpers, not an error
    try {
      for (; p.started < threads - 1; ++p.started)
        std::thread([&p] { p.helper(); }).detach();
    } catch (const std::system_error&) {
    }
    p.job = &j;
    ++p.posted;
  }
  p.wake.notify_all();
  j.work();
  {
    // no helper joins from here on; wait for those inside
    std::lock_guard<std::mutex> lk(p.mu);
    p.job = nullptr;
  }
  while (p.joined.load(std::memory_order_acquire) > 0)
    std::this_thread::yield();
}
