// Native async checkpoint chunk writer (the port's copy of
// vescale_tpu/checkpoint/native/ckpt_io.cpp).
//
// Capability parity with the reference's native-backed checkpoint io
// (legacy/vescale/checkpoint/storage/filesystem.py: async io workers over
// pinned-memory staging).  The device-to-host copy happens on the caller's
// thread (storage.array_to_bytes); what is native here is the write path:
// a C++ thread pool doing open/write/fsync/rename outside the GIL, so
// checkpoint io never serializes against the Python thread.
//
// Protocol (C ABI, ctypes-friendly):
//   void*  vck_create(int num_threads)
//   int    vck_submit(void* pool, const char* path, const void* data,
//                     uint64_t len)       // copies data; 0 on enqueue
//   int    vck_drain(void* pool)          // waits; returns #failed writes
//   void   vck_destroy(void* pool)
//
// Writes are atomic per file: data lands in "<path>.tmp", fsync'd, then
// rename()d over the target (same commit discipline as the python
// FileSystemStorage).  Parent directories are created as needed.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

struct Job {
  std::string path;
  std::vector<char> data;
};

struct Pool {
  std::vector<std::thread> workers;
  std::deque<Job> queue;
  std::mutex mu;
  std::condition_variable cv;       // queue -> workers
  std::condition_variable cv_done;  // workers -> drain
  bool stopping = false;
  int in_flight = 0;
  std::atomic<int> failures{0};

  void worker() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stopping || !queue.empty(); });
        if (queue.empty()) {
          if (stopping) return;
          continue;
        }
        job = std::move(queue.front());
        queue.pop_front();
        ++in_flight;
      }
      if (!write_one(job)) failures.fetch_add(1);
      {
        std::lock_guard<std::mutex> lk(mu);
        --in_flight;
      }
      cv_done.notify_all();
    }
  }

  static bool mkdirs(const std::string& path) {
    // create every parent directory of `path`
    for (size_t i = 1; i < path.size(); ++i) {
      if (path[i] == '/') {
        std::string dir = path.substr(0, i);
        if (::mkdir(dir.c_str(), 0777) != 0 && errno != EEXIST) return false;
      }
    }
    return true;
  }

  static bool write_one(const Job& job) {
    if (!mkdirs(job.path)) return false;
    const std::string tmp = job.path + ".tmp";
    int fd = ::open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (fd < 0) return false;
    const char* p = job.data.data();
    size_t left = job.data.size();
    while (left > 0) {
      ssize_t n = ::write(fd, p, left);
      if (n < 0) {
        if (errno == EINTR) continue;
        ::close(fd);
        ::unlink(tmp.c_str());
        return false;
      }
      p += n;
      left -= static_cast<size_t>(n);
    }
    // fsync BEFORE rename: the rename is the commit point, and a committed
    // name must never refer to data still in the page cache only
    if (::fsync(fd) != 0) {
      ::close(fd);
      ::unlink(tmp.c_str());
      return false;
    }
    ::close(fd);
    if (::rename(tmp.c_str(), job.path.c_str()) != 0) {
      ::unlink(tmp.c_str());
      return false;
    }
    // fsync the parent directory: the rename is only durable once the
    // directory entry is
    const size_t slash = job.path.rfind('/');
    if (slash != std::string::npos) {
      const std::string dir = job.path.substr(0, slash);
      int dfd = ::open(dir.c_str(), O_RDONLY);
      if (dfd >= 0) {
        ::fsync(dfd);
        ::close(dfd);
      }
    }
    return true;
  }
};

}  // namespace

extern "C" {

void* vck_create(int num_threads) {
  auto* pool = new Pool();
  if (num_threads < 1) num_threads = 1;
  pool->workers.reserve(static_cast<size_t>(num_threads));
  for (int i = 0; i < num_threads; ++i) {
    pool->workers.emplace_back([pool] { pool->worker(); });
  }
  return pool;
}

int vck_submit(void* p, const char* path, const void* data, uint64_t len) {
  auto* pool = static_cast<Pool*>(p);
  Job job;
  job.path = path;
  job.data.resize(len);
  if (len) std::memcpy(job.data.data(), data, len);
  {
    std::lock_guard<std::mutex> lk(pool->mu);
    if (pool->stopping) return -1;
    pool->queue.push_back(std::move(job));
  }
  pool->cv.notify_one();
  return 0;
}

int vck_drain(void* p) {
  auto* pool = static_cast<Pool*>(p);
  std::unique_lock<std::mutex> lk(pool->mu);
  pool->cv_done.wait(lk, [&] { return pool->queue.empty() && pool->in_flight == 0; });
  return pool->failures.exchange(0);
}

void vck_destroy(void* p) {
  auto* pool = static_cast<Pool*>(p);
  {
    std::lock_guard<std::mutex> lk(pool->mu);
    pool->stopping = true;
  }
  pool->cv.notify_all();
  for (auto& t : pool->workers) t.join();
  delete pool;
}

}  // extern "C"
