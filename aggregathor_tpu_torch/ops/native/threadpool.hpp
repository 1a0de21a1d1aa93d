// Host thread pool + parallel_for for the native GAR kernels.
//
// Fresh C++17 design standing in for the reference's global pool
// (native/so_threadpool/threadpool.cpp, threadpool.hpp:219-239): a lazily
// created process-wide pool of hardware_concurrency() workers draining a
// condition-variable task queue, and a blocking range splitter that chunks
// [begin, end) into ~4x-oversubscribed cache-friendly slices.  Lifetime of
// each parallel_for's shared state is owned by a shared_ptr captured in the
// task closures, so there is no completion race by construction.
#pragma once

#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace agtpu {

class ThreadPool {
 public:
  explicit ThreadPool(std::size_t nthreads) {
    if (nthreads < 1) nthreads = 1;
    workers_.reserve(nthreads);
    for (std::size_t i = 0; i < nthreads; ++i) {
      workers_.emplace_back([this] { WorkerLoop(); });
    }
  }

  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }

  ThreadPool(const ThreadPool&) = delete;
  ThreadPool& operator=(const ThreadPool&) = delete;

  std::size_t size() const { return workers_.size(); }

  void Submit(std::function<void()> task) {
    {
      std::lock_guard<std::mutex> lock(mu_);
      queue_.push_back(std::move(task));
    }
    cv_.notify_one();
  }

  // Process-wide pool; AGTPU_NUM_THREADS overrides the worker count.
  static ThreadPool& Global() {
    static ThreadPool pool(DefaultThreads());
    return pool;
  }

 private:
  static std::size_t DefaultThreads() {
    if (const char* env = std::getenv("AGTPU_NUM_THREADS")) {
      long v = std::strtol(env, nullptr, 10);
      if (v > 0) return static_cast<std::size_t>(v);
    }
    std::size_t hw = std::thread::hardware_concurrency();
    return hw > 0 ? hw : 1;
  }

  void WorkerLoop() {
    for (;;) {
      std::function<void()> task;
      {
        std::unique_lock<std::mutex> lock(mu_);
        cv_.wait(lock, [this] { return stop_ || !queue_.empty(); });
        if (stop_ && queue_.empty()) return;
        task = std::move(queue_.front());
        queue_.pop_front();
      }
      task();
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<std::function<void()>> queue_;
  bool stop_ = false;
  std::vector<std::thread> workers_;
};

// Run body(lo, hi) over disjoint slices covering [begin, end), blocking until
// every slice completed.  Serial when the range or the pool is trivial.
template <typename Body>
void ParallelFor(std::int64_t begin, std::int64_t end, const Body& body) {
  const std::int64_t n = end - begin;
  if (n <= 0) return;
  ThreadPool& pool = ThreadPool::Global();
  const std::int64_t max_chunks =
      static_cast<std::int64_t>(pool.size()) * 4;
  const std::int64_t nchunks = n < max_chunks ? n : max_chunks;
  if (pool.size() <= 1 || nchunks <= 1) {
    body(begin, end);
    return;
  }

  struct Sync {
    std::mutex mu;
    std::condition_variable done;
    std::int64_t pending;
  };
  auto sync = std::make_shared<Sync>();
  sync->pending = nchunks;

  const std::int64_t chunk = (n + nchunks - 1) / nchunks;
  for (std::int64_t c = 0; c < nchunks; ++c) {
    const std::int64_t lo = begin + c * chunk;
    const std::int64_t hi = lo + chunk < end ? lo + chunk : end;
    pool.Submit([sync, lo, hi, &body] {
      body(lo, hi);
      std::lock_guard<std::mutex> lock(sync->mu);
      if (--sync->pending == 0) sync->done.notify_all();
    });
  }
  std::unique_lock<std::mutex> lock(sync->mu);
  sync->done.wait(lock, [&] { return sync->pending == 0; });
}

}  // namespace agtpu
