// graphio — native packed-graph-record reader for relpose_gnn_tpu_torch.
//
// The port's own copy of the JAX package's host runtime: batches are served
// out of mmap'd packed arrays (data/packed.py layout) by a worker-thread
// pool doing the strided gather, plus an async double-buffered prefetcher,
// bound to Python with ctypes (data/native_io.py builds this file with g++
// into the package's _build/ directory on first use).  Host code only: no
// device work happens here.
//
// API (all C linkage):
//   gio_open(path, data_offset)                 -> file handle (mmap)
//   gio_gather(h, rec_bytes, idx*, n, out*)     -> parallel strided copy
//   gio_close(h)
//   gpf_create(handles*, rec_bytes*, n_arrays, threads) -> prefetcher
//   gpf_submit(p, idx*, n, out_ptrs*)           -> enqueue async batch fill
//   gpf_wait(p)                                 -> block until current done
//   gpf_destroy(p)
//
// Indices are not checked here: the Python side validates them against
// the record count before it passes a pointer.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct MappedFile {
  int fd = -1;
  uint8_t *base = nullptr;
  size_t size = 0;
  size_t data_offset = 0;
};

// Simple reusable thread pool for gather jobs.
struct Pool {
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  // current job
  const MappedFile *file = nullptr;
  size_t rec_bytes = 0;
  const int64_t *indices = nullptr;
  int64_t n = 0;
  uint8_t *out = nullptr;
  std::atomic<int64_t> next{0};
  std::atomic<int64_t> done{0};
  std::atomic<int64_t> target{0};  // records in current job
  bool stop = false;
  uint64_t generation = 0;

  explicit Pool(int threads) {
    for (int i = 0; i < threads; ++i)
      workers.emplace_back([this] { run(); });
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_work.notify_all();
    for (auto &w : workers) w.join();
  }

  void run() {
    uint64_t seen_gen = 0;
    for (;;) {
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return stop || generation != seen_gen; });
        if (stop) return;
        seen_gen = generation;
      }
      for (;;) {
        int64_t i = next.fetch_add(1);
        if (i >= target) break;
        const uint8_t *src =
            file->base + file->data_offset + (size_t)indices[i] * rec_bytes;
        std::memcpy(out + (size_t)i * rec_bytes, src, rec_bytes);
        done.fetch_add(1);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        if (done.load() >= target) cv_done.notify_all();
      }
    }
  }

  void gather(const MappedFile *f, size_t rb, const int64_t *idx, int64_t cnt,
              uint8_t *dst) {
    {
      std::lock_guard<std::mutex> lk(mu);
      file = f;
      rec_bytes = rb;
      indices = idx;
      n = cnt;
      out = dst;
      done.store(0);
      target.store(cnt);
      // last: a worker that takes an index of this job through `next`
      // must already see its target and buffers
      next.store(0);
      ++generation;
    }
    cv_work.notify_all();
    std::unique_lock<std::mutex> lk(mu);
    cv_done.wait(lk, [&] { return done.load() >= target; });
  }
};

}  // namespace

extern "C" {

void *gio_open(const char *path, uint64_t data_offset) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void *base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  madvise(base, st.st_size, MADV_WILLNEED);
  auto *mf = new MappedFile;
  mf->fd = fd;
  mf->base = static_cast<uint8_t *>(base);
  mf->size = st.st_size;
  mf->data_offset = data_offset;
  return mf;
}

void gio_close(void *handle) {
  auto *mf = static_cast<MappedFile *>(handle);
  if (!mf) return;
  munmap(mf->base, mf->size);
  ::close(mf->fd);
  delete mf;
}

// Synchronous parallel gather with a transient pool-free path: for small
// batches a single memcpy loop beats thread dispatch.
int gio_gather(void *handle, uint64_t rec_bytes, const int64_t *indices,
               int64_t n, uint8_t *out, int threads) {
  auto *mf = static_cast<MappedFile *>(handle);
  if (!mf) return -1;
  if (threads <= 1 || n < 4) {
    for (int64_t i = 0; i < n; ++i) {
      std::memcpy(out + (size_t)i * rec_bytes,
                  mf->base + mf->data_offset + (size_t)indices[i] * rec_bytes,
                  rec_bytes);
    }
    return 0;
  }
  std::vector<std::thread> ts;
  std::atomic<int64_t> next{0};
  for (int t = 0; t < threads; ++t) {
    ts.emplace_back([&] {
      for (;;) {
        int64_t i = next.fetch_add(1);
        if (i >= n) return;
        std::memcpy(
            out + (size_t)i * rec_bytes,
            mf->base + mf->data_offset + (size_t)indices[i] * rec_bytes,
            rec_bytes);
      }
    });
  }
  for (auto &t : ts) t.join();
  return 0;
}

// ---------------------------------------------------------------------------
// Async prefetcher: fills one batch (across several arrays) in background.
// ---------------------------------------------------------------------------

struct Prefetcher {
  std::vector<MappedFile *> files;
  std::vector<uint64_t> rec_bytes;
  Pool pool;
  std::thread runner;
  std::mutex mu;
  std::condition_variable cv;
  bool has_job = false, stop = false, job_done = true;
  std::vector<int64_t> idx;
  std::vector<uint8_t *> outs;

  Prefetcher(int threads) : pool(threads) {
    runner = std::thread([this] { loop(); });
  }

  ~Prefetcher() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv.notify_all();
    runner.join();
  }

  void loop() {
    for (;;) {
      std::vector<int64_t> local_idx;
      std::vector<uint8_t *> local_outs;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop || has_job; });
        if (stop) return;
        local_idx = idx;
        local_outs = outs;
        has_job = false;
      }
      for (size_t a = 0; a < files.size(); ++a) {
        pool.gather(files[a], rec_bytes[a], local_idx.data(),
                    (int64_t)local_idx.size(), local_outs[a]);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        job_done = true;
        cv.notify_all();
      }
    }
  }

  void submit(const int64_t *indices, int64_t n, uint8_t **out_ptrs) {
    std::lock_guard<std::mutex> lk(mu);
    idx.assign(indices, indices + n);
    outs.assign(out_ptrs, out_ptrs + files.size());
    has_job = true;
    job_done = false;
    cv.notify_all();
  }

  void wait() {
    std::unique_lock<std::mutex> lk(mu);
    cv.wait(lk, [&] { return job_done; });
  }
};

void *gpf_create(void **handles, const uint64_t *rec_bytes, int n_arrays,
                 int threads) {
  auto *p = new Prefetcher(threads);
  for (int i = 0; i < n_arrays; ++i) {
    p->files.push_back(static_cast<MappedFile *>(handles[i]));
    p->rec_bytes.push_back(rec_bytes[i]);
  }
  return p;
}

void gpf_submit(void *pf, const int64_t *indices, int64_t n,
                uint8_t **out_ptrs) {
  static_cast<Prefetcher *>(pf)->submit(indices, n, out_ptrs);
}

void gpf_wait(void *pf) { static_cast<Prefetcher *>(pf)->wait(); }

void gpf_destroy(void *pf) { delete static_cast<Prefetcher *>(pf); }

}  // extern "C"
