// Native threaded batch prefetcher for packed sample files (the port's copy of
// the JAX package's runtime, with short reads reported instead of zero-filled).
//
// Replaces the reference's torch DataLoader worker processes (main.py:58-65) with a
// C++ thread pool + ring buffer: producer threads pread() fixed-size sample records
// from a packed binary file (see sml_tpu_torch/data/packed.py for the format) and
// assemble them into batch buffers; the Python side copies each assembled batch
// out through ctypes.
//
// Exposed C ABI:
//   pf_open(path, record_bytes, batch_size, queue_depth, n_threads) -> handle
//   pf_submit(handle, indices, n)   — enqueue one epoch's index order (batches of
//                                     batch_size; n must be a multiple of batch_size)
//   pf_next(handle) -> const uint8* — block until the next batch buffer is ready
//                                     (valid until the following pf_next/pf_close);
//                                     null if a record could not be read in full
//   pf_close(handle)
//
// Build: g++ -O2 -shared -fPIC -pthread prefetch.cpp -o libprefetch.so
// (sml_tpu_torch/runtime/__init__.py builds it at first use)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

struct Batch {
  std::vector<uint8_t> data;
  long seq = -1;          // batch sequence number, for in-order delivery
  bool ready = false;
  bool short_read = false;  // a record ran past the end of the file or failed
};

struct Prefetcher {
  int fd = -1;
  size_t record_bytes = 0;
  size_t batch_size = 0;
  size_t queue_depth = 0;

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_work;    // producers wait for work / slots
  std::condition_variable cv_ready;   // consumer waits for the next in-order batch

  std::deque<std::vector<int64_t>> pending;  // batches of record indices
  long next_submit_seq = 0;                  // seq assigned to the next pending batch
  long next_consume_seq = 0;                 // seq the consumer wants
  long inflight_limit = 0;

  std::vector<Batch> slots;                  // queue_depth + 1 reusable buffers
  std::vector<uint8_t> out;                  // buffer handed to the consumer
  std::atomic<bool> stop{false};

  ~Prefetcher() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_work.notify_all();
    for (auto& t : workers) t.join();
    if (fd >= 0) close(fd);
  }

  void worker() {
    for (;;) {
      std::vector<int64_t> idx;
      long seq;
      Batch* slot = nullptr;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] {
          return stop || (!pending.empty()&& free_slot_locked() != nullptr
                          && next_submit_seq < next_consume_seq + inflight_limit);
        });
        if (stop) return;
        idx = std::move(pending.front());
        pending.pop_front();
        seq = next_submit_seq++;
        slot = free_slot_locked();
        slot->seq = seq;
        slot->ready = false;
      }
      // read records outside the lock
      slot->data.resize(batch_size * record_bytes);
      bool short_read = false;
      for (size_t i = 0; i < idx.size(); ++i) {
        ssize_t off = (ssize_t)idx[i] * (ssize_t)record_bytes;
        size_t done = 0;
        while (done < record_bytes) {
          ssize_t r = pread(fd, slot->data.data() + i * record_bytes + done,
                            record_bytes - done, off + done);
          if (r <= 0) { short_read = true; break; }
          done += (size_t)r;
        }
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        slot->short_read = short_read;
        slot->ready = true;
      }
      cv_ready.notify_all();
    }
  }

  Batch* free_slot_locked() {
    // free slots carry seq == -1 (initial, or reset by the consumer after delivery);
    // assigned slots always have seq >= next_consume_seq
    for (auto& s : slots)
      if (s.seq == -1) return &s;
    return nullptr;
  }

  const uint8_t* next() {
    std::unique_lock<std::mutex> lk(mu);
    Batch* mine = nullptr;
    cv_ready.wait(lk, [&] {
      for (auto& s : slots)
        if (s.seq == next_consume_seq && s.ready) { mine = &s; return true; }
      return false;
    });
    out = std::move(mine->data);
    bool failed = mine->short_read;
    mine->seq = -1;
    mine->ready = false;
    ++next_consume_seq;
    lk.unlock();
    cv_work.notify_all();
    return failed ? nullptr : out.data();
  }
};

}  // namespace

extern "C" {

void* pf_open(const char* path, int64_t record_bytes, int64_t batch_size,
              int64_t queue_depth, int64_t n_threads) {
  auto* p = new Prefetcher();
  p->fd = open(path, O_RDONLY);
  if (p->fd < 0) { delete p; return nullptr; }
  p->record_bytes = (size_t)record_bytes;
  p->batch_size = (size_t)batch_size;
  p->queue_depth = (size_t)queue_depth;
  p->inflight_limit = queue_depth;
  p->slots.resize((size_t)queue_depth + 1);
  for (auto& s : p->slots) s.seq = -1;
  for (int64_t i = 0; i < n_threads; ++i)
    p->workers.emplace_back([p] { p->worker(); });
  return p;
}

int64_t pf_submit(void* handle, const int64_t* indices, int64_t n) {
  auto* p = static_cast<Prefetcher*>(handle);
  if (n % (int64_t)p->batch_size != 0) return -1;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    for (int64_t start = 0; start < n; start += (int64_t)p->batch_size)
      p->pending.emplace_back(indices + start, indices + start + p->batch_size);
  }
  p->cv_work.notify_all();
  return n / (int64_t)p->batch_size;
}

const uint8_t* pf_next(void* handle) {
  return static_cast<Prefetcher*>(handle)->next();
}

void pf_close(void* handle) {
  delete static_cast<Prefetcher*>(handle);
}

}  // extern "C"
