// Parallel checkpoint writer pool (host C++, no CUDA).
//
// Own copy of deepspeed_tpu/csrc/ckpt_writer.cpp, the counterpart of the
// reference's VELOC writer threads (csrc/veloc/deepspeed_py_veloc.cu: _h2f_trf
// at cu:94 pwrites device snapshots from a pinned host cache) and the AIO
// thread pool (csrc/aio/deepspeed_aio_thread.cpp:104). The D2H staging is
// done in Python (runtime/engine.py save_checkpoint copies each shard to
// host memory); this pool owns the disk half: chunked pwrite across N
// threads, optional fsync, so a multi-GB checkpoint hits disk at the
// storage's bandwidth instead of a single-threaded write() rate.
//
// C ABI only (loaded via ctypes, ops/native/ckpt_writer.py).

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <unistd.h>
#include <vector>

#include "pool.h"

namespace {
using WriterPool = dstpu::WorkerPool;


int pwrite_full(int fd, const char* buf, int64_t count, int64_t offset) {
  while (count > 0) {
    ssize_t n = ::pwrite(fd, buf, static_cast<size_t>(count), offset);
    if (n < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    buf += n;
    offset += n;
    count -= n;
  }
  return 0;
}

}  // namespace

extern "C" {

void* ckpt_writer_create(int n_threads) { return new WriterPool(n_threads); }

void ckpt_writer_destroy(void* pool) {
  delete static_cast<WriterPool*>(pool);
}

// Write `nbytes` from `data` to `path`, chunked across the pool's threads.
// Returns 0 on success, -errno on the first failure. Synchronous w.r.t. the
// caller (python calls it from its own background thread), parallel inside.
int ckpt_writer_write(void* pool_ptr, const char* path, const void* data,
                      int64_t nbytes, int do_fsync) {
  auto* pool = static_cast<WriterPool*>(pool_ptr);
  int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -errno;
  if (::ftruncate(fd, nbytes) != 0) {
    int err = -errno;
    ::close(fd);
    return err;
  }

  const int n_chunks = pool->n_threads();
  const int64_t chunk = (nbytes + n_chunks - 1) / n_chunks;
  std::atomic<int> err{0};
  std::atomic<int> remaining{0};
  std::mutex done_mu;
  std::condition_variable done_cv;

  const char* base = static_cast<const char*>(data);
  for (int i = 0; i < n_chunks; ++i) {
    int64_t off = static_cast<int64_t>(i) * chunk;
    if (off >= nbytes) break;
    int64_t len = std::min(chunk, nbytes - off);
    remaining.fetch_add(1);
    pool->submit([=, &err, &remaining, &done_mu, &done_cv] {
      int rc = pwrite_full(fd, base + off, len, off);
      if (rc != 0) {
        int expected = 0;
        err.compare_exchange_strong(expected, rc);
      }
      if (remaining.fetch_sub(1) == 1) {
        std::unique_lock<std::mutex> lk(done_mu);
        done_cv.notify_all();
      }
    });
  }
  {
    std::unique_lock<std::mutex> lk(done_mu);
    done_cv.wait(lk, [&] { return remaining.load() == 0; });
  }
  if (err.load() == 0 && do_fsync) {
    if (::fsync(fd) != 0) err.store(-errno);
  }
  ::close(fd);
  return err.load();
}

}  // extern "C"
