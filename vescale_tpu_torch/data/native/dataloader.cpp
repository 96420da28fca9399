// vescale_tpu_torch native data loader: nanoGPT-style batches of next-token
// pairs from a binary token file, sampled by background prefetch threads
// from an mmap'd file into a ring of batch buffers, so the host input path
// stays off the card's step.  Python (ctypes, data/loader.py) hands out the
// filled buffers.
//
// A copy of the JAX package's loader source: the C API, its ABI version and
// the sampling below are unchanged, so both packages draw the same stream
// from the same (file, seed, dp coords).
//
// C API (see data/loader.py):
//   vdl_open(path, token_bytes, seq_len, batch, seed, rank, world, nprefetch,
//            elastic)
//   vdl_next(handle, x_out, y_out)   -> blocks until a batch is ready
//   vdl_seek(handle, index)          -> forward-seek the serve cursor
//   vdl_num_tokens(handle)
//   vdl_abi_version()                -> bumped on any signature change so a
//                                       stale prebuilt .so forces a rebuild
//   vdl_close(handle)
//
// Sampling, elastic == 0 (default): deterministic per (seed, rank,
// batch_index) via SplitMix64 -- rank r of `world` draws from a disjoint
// start-offset partition of the file, so DP ranks see different data while
// runs are reproducible.  x = tokens[i : i+seq_len],
// y = tokens[i+1 : i+seq_len+1] (next-token targets).
//
// Sampling, elastic == 1: every sample is keyed on its GLOBAL row index
//   g = batch_index * (batch * world) + rank * batch + row
// over the FULL span -- the global token stream is a pure function of
// (seed, g), invariant to how (world, per-rank batch) split a fixed global
// batch.  This is what makes a checkpoint resumable on a different world
// size with no sample skipped or replayed (elastic world-size resume);
// rank r still serves the contiguous global-batch slice [r*batch,(r+1)*batch).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <fcntl.h>
#include <mutex>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct SplitMix64 {
  uint64_t state;
  explicit SplitMix64(uint64_t seed) : state(seed) {}
  uint64_t next() {
    uint64_t z = (state += 0x9E3779B97F4A7C15ull);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
  }
};

struct Batch {
  std::vector<int32_t> x;
  std::vector<int32_t> y;
};

struct Loader {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t file_bytes = 0;
  int token_bytes = 2;  // uint16 or 4 for uint32/int32
  size_t num_tokens = 0;
  int64_t seq_len = 0;
  int64_t batch = 0;
  uint64_t seed = 0;
  int64_t rank = 0, world = 1;
  int elastic = 0;  // world-invariant global-row sampling (header comment)
  std::atomic<uint64_t> batch_counter{0};

  // prefetch ring, served strictly in batch-index order so multi-threaded
  // prefetch stays deterministic
  std::map<uint64_t, Batch> ready;
  uint64_t next_serve = 0;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  size_t max_ready = 4;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  int32_t token_at(size_t i) const {
    if (token_bytes == 2) {
      uint16_t v;
      std::memcpy(&v, map + i * 2, 2);
      return static_cast<int32_t>(v);
    }
    int32_t v;
    std::memcpy(&v, map + i * 4, 4);
    return v;
  }

  void fill(Batch& b, uint64_t index) {
    b.x.resize(batch * seq_len);
    b.y.resize(batch * seq_len);
    size_t full_span = num_tokens - (size_t)seq_len - 1;
    if (elastic) {
      // world-invariant: sample g = global row index over the FULL span —
      // any (world, per-rank batch) factorization of the same global batch
      // reproduces the identical global token stream (elastic resume)
      for (int64_t row = 0; row < batch; ++row) {
        uint64_t g = index * (uint64_t)(batch * world) +
                     (uint64_t)rank * (uint64_t)batch + (uint64_t)row;
        SplitMix64 rng(seed * 0x9E3779B97F4A7C15ull + g * 0xD1B54A32D192ED03ull);
        size_t start = (size_t)(rng.next() % full_span);
        for (int64_t t = 0; t < seq_len; ++t) {
          b.x[row * seq_len + t] = token_at(start + t);
          b.y[row * seq_len + t] = token_at(start + t + 1);
        }
      }
      return;
    }
    // deterministic per (seed, rank, batch index); ranks draw from DISJOINT
    // start-offset partitions of the file so dp shards never overlap
    size_t rank_span = full_span / (size_t)world;
    size_t rank_base = (size_t)rank * rank_span;
    if (rank_span == 0) {  // degenerate tiny file: fall back to shared span
      rank_span = full_span;
      rank_base = 0;
    }
    for (int64_t row = 0; row < batch; ++row) {
      SplitMix64 rng(seed * 0x9E3779B97F4A7C15ull + (uint64_t)rank * 0x85EBCA77C2B2AE63ull +
                     index * 1000003ull + (uint64_t)row);
      size_t start = rank_base + (size_t)(rng.next() % rank_span);
      for (int64_t t = 0; t < seq_len; ++t) {
        b.x[row * seq_len + t] = token_at(start + t);
        b.y[row * seq_len + t] = token_at(start + t + 1);
      }
    }
  }

  void worker_loop() {
    while (!stop.load()) {
      // wait for space BEFORE claiming an index: a worker that claimed the
      // next-to-serve index must never block behind later batches (deadlock)
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] { return ready.size() < max_ready || stop.load(); });
      }
      if (stop.load()) return;
      uint64_t index = batch_counter.fetch_add(1);
      Batch b;
      fill(b, index);
      std::unique_lock<std::mutex> lk(mu);
      if (stop.load()) return;
      // insert unless a seek already moved the cursor past this index (a
      // stale batch would pile up in `ready` forever); ready may briefly
      // exceed max_ready by up to the worker count, which is bounded and
      // preserves in-order serving
      if (index >= next_serve) {
        ready.emplace(index, std::move(b));
        cv_ready.notify_all();
      }
    }
  }
};

}  // namespace

extern "C" {

// bumped on any C-API signature change: the Python side refuses (and
// rebuilds) a stale prebuilt .so instead of calling through a mismatched
// ABI, where an extra trailing argument would be SILENTLY ignored
int vdl_abi_version() { return 2; }

void* vdl_open(const char* path, int token_bytes, int64_t seq_len, int64_t batch,
               uint64_t seed, int64_t rank, int64_t world, int n_prefetch,
               int elastic) {
  auto* L = new Loader();
  L->token_bytes = token_bytes;
  L->seq_len = seq_len;
  L->batch = batch;
  L->seed = seed;
  L->rank = rank;
  L->world = world <= 0 ? 1 : world;
  L->elastic = elastic != 0 ? 1 : 0;
  L->fd = ::open(path, O_RDONLY);
  if (L->fd < 0) {
    delete L;
    return nullptr;
  }
  struct stat st;
  if (fstat(L->fd, &st) != 0) {
    ::close(L->fd);
    delete L;
    return nullptr;
  }
  L->file_bytes = (size_t)st.st_size;
  L->num_tokens = L->file_bytes / (size_t)token_bytes;
  if ((int64_t)L->num_tokens <= seq_len + 1) {
    ::close(L->fd);
    delete L;
    return nullptr;
  }
  L->map = (const uint8_t*)::mmap(nullptr, L->file_bytes, PROT_READ, MAP_PRIVATE, L->fd, 0);
  if (L->map == MAP_FAILED) {
    ::close(L->fd);
    delete L;
    return nullptr;
  }
  ::madvise((void*)L->map, L->file_bytes, MADV_RANDOM);
  int n = n_prefetch <= 0 ? 2 : n_prefetch;
  L->max_ready = (size_t)n * 2;
  for (int i = 0; i < n; ++i) L->workers.emplace_back([L] { L->worker_loop(); });
  return L;
}

int64_t vdl_num_tokens(void* handle) {
  return handle ? (int64_t)((Loader*)handle)->num_tokens : -1;
}

int vdl_next(void* handle, int32_t* x_out, int32_t* y_out) {
  if (!handle) return -1;
  auto* L = (Loader*)handle;
  Batch b;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_ready.wait(lk, [&] { return L->ready.count(L->next_serve) > 0; });
    auto it = L->ready.find(L->next_serve);
    b = std::move(it->second);
    L->ready.erase(it);
    ++L->next_serve;
    L->cv_space.notify_all();
  }
  std::memcpy(x_out, b.x.data(), b.x.size() * sizeof(int32_t));
  std::memcpy(y_out, b.y.data(), b.y.size() * sizeof(int32_t));
  return 0;
}

int vdl_seek(void* handle, uint64_t target) {
  // Forward-seek the serve cursor to batch `target` (resume fast-forward:
  // batches are generated independently per index, so skipping is O(1) —
  // no fill work is owed for the skipped range).  Backward seeks are
  // rejected; the Python side reopens the loader instead (prefetch state
  // cannot be rewound).
  if (!handle) return -1;
  auto* L = (Loader*)handle;
  std::unique_lock<std::mutex> lk(L->mu);
  if (target < L->next_serve) return -2;
  // drop prefetched batches the seek skips over
  for (auto it = L->ready.begin(); it != L->ready.end();) {
    if (it->first < target)
      it = L->ready.erase(it);
    else
      ++it;
  }
  L->next_serve = target;
  // advance the claim counter so workers start filling from `target`; a
  // worker mid-fill on a stale index is handled by the insert guard above
  uint64_t cur = L->batch_counter.load();
  while (cur < target && !L->batch_counter.compare_exchange_weak(cur, target)) {
  }
  L->cv_space.notify_all();
  return 0;
}

void vdl_close(void* handle) {
  if (!handle) return;
  auto* L = (Loader*)handle;
  {
    // hold the mutex while flipping stop: a worker between predicate check
    // and blocking would otherwise miss the wakeup and hang join() forever
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop.store(true);
  }
  L->cv_space.notify_all();
  L->cv_ready.notify_all();
  for (auto& t : L->workers)
    if (t.joinable()) t.join();
  if (L->map && L->map != MAP_FAILED) ::munmap((void*)L->map, L->file_bytes);
  if (L->fd >= 0) ::close(L->fd);
  delete L;
}

}  // extern "C"
