// Worker-queue thread pool for the host-side C++ ops (ckpt_writer.cpp).
// Own copy of deepspeed_tpu/csrc/pool.h.
//
// ParallelFor: fan a [0, n) index range across the pool in contiguous
// slabs and BLOCK until every slab finished — completion state lives in a
// heap-shared block so a late-finishing worker can never touch stack
// memory after the caller returns (the use-after-scope class of bug).
#pragma once

#include <condition_variable>
#include <cstdint>
#include <functional>
#include <memory>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace dstpu {

class WorkerPool {
 public:
  explicit WorkerPool(int n_threads) {
    if (n_threads < 1) n_threads = 1;
    for (int i = 0; i < n_threads; ++i)
      workers_.emplace_back([this] { run(); });
  }

  ~WorkerPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto &w : workers_) w.join();
  }

  int n_threads() const { return static_cast<int>(workers_.size()); }

  void submit(std::function<void()> fn) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      q_.push(std::move(fn));
    }
    cv_.notify_one();
  }

  // Run body(begin, end) over [0, n) in n_threads slabs; waits for all.
  void parallel_for(int64_t n,
                    const std::function<void(int64_t, int64_t)> &body) {
    struct Done {
      std::mutex mu;
      std::condition_variable cv;
      int remaining = 0;
    };
    auto done = std::make_shared<Done>();
    const int64_t slab = (n + n_threads() - 1) / n_threads();
    for (int t = 0; t < n_threads(); ++t) {
      int64_t begin = static_cast<int64_t>(t) * slab;
      if (begin >= n) break;
      int64_t end = begin + slab < n ? begin + slab : n;
      {
        std::lock_guard<std::mutex> lk(done->mu);
        done->remaining += 1;
      }
      submit([done, begin, end, &body] {
        body(begin, end);
        std::lock_guard<std::mutex> lk(done->mu);
        done->remaining -= 1;
        if (done->remaining == 0) done->cv.notify_all();
      });
    }
    std::unique_lock<std::mutex> lk(done->mu);
    done->cv.wait(lk, [&] { return done->remaining == 0; });
  }

 private:
  void run() {
    for (;;) {
      std::function<void()> fn;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !q_.empty(); });
        if (stop_ && q_.empty()) return;
        fn = std::move(q_.front());
        q_.pop();
      }
      fn();
    }
  }

  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> q_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_ = false;
};

}  // namespace dstpu
