// Native training data loader of seldon_tpu_torch: a copy of the JAX
// package's native/dataloader.cc, built by seldon_tpu_torch/native into
// build/native/ (never into native/, where the JAX package builds).
//
// Memory-mapped token shards + a background prefetch thread filling a
// bounded ring of ready batches, exposed over a plain C ABI (ctypes).
//
// Determinism contract shared with the numpy path
// (seldon_tpu_torch/data/loader.py): batch i's row r samples window offset
//   splitmix64(seed ^ (i * B + r)) % (n_tokens - (seq_len + 1))
// so the native and numpy paths produce BIT-IDENTICAL streams (tested).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

struct Shard {
  const uint32_t* data = nullptr;
  size_t n_tokens = 0;
  size_t mapped_bytes = 0;
  int fd = -1;
};

struct Loader {
  std::vector<Shard> shards;
  size_t total_tokens = 0;
  int64_t batch = 0;
  int64_t seq_plus1 = 0;  // seq_len + 1 (input + shifted target)
  uint64_t seed = 0;

  // Ring of prefetched batches (each batch*seq_plus1 int32).
  std::vector<std::vector<int32_t>> ring;
  size_t capacity = 0;
  size_t head = 0, tail = 0, count = 0;
  uint64_t next_to_fill = 0;  // batch counter for the producer

  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  std::thread worker;
  std::atomic<bool> stop{false};

  uint32_t token_at(size_t idx) const {
    for (const auto& s : shards) {
      if (idx < s.n_tokens) return s.data[idx];
      idx -= s.n_tokens;
    }
    return 0;  // unreachable for valid idx
  }

  void fill_batch(uint64_t batch_idx, int32_t* out) const {
    const uint64_t window = total_tokens - (uint64_t)seq_plus1;
    for (int64_t r = 0; r < batch; ++r) {
      uint64_t off =
          splitmix64(seed ^ (batch_idx * (uint64_t)batch + (uint64_t)r)) %
          window;
      // Fast path: window fully inside one shard -> memcpy.
      size_t idx = off;
      bool copied = false;
      for (const auto& s : shards) {
        if (idx + (size_t)seq_plus1 <= s.n_tokens) {
          for (int64_t t = 0; t < seq_plus1; ++t)
            out[r * seq_plus1 + t] = (int32_t)s.data[idx + t];
          copied = true;
          break;
        }
        if (idx < s.n_tokens) break;  // straddles shard boundary
        idx -= s.n_tokens;
      }
      if (!copied) {
        for (int64_t t = 0; t < seq_plus1; ++t)
          out[r * seq_plus1 + t] = (int32_t)token_at(off + (size_t)t);
      }
    }
  }

  void run() {
    while (!stop.load()) {
      std::unique_lock<std::mutex> lk(mu);
      cv_full.wait(lk, [&] { return count < capacity || stop.load(); });
      if (stop.load()) return;
      uint64_t idx = next_to_fill++;
      auto& slot = ring[tail];
      lk.unlock();
      fill_batch(idx, slot.data());  // slow work outside the lock
      lk.lock();
      tail = (tail + 1) % capacity;
      ++count;
      cv_empty.notify_one();
    }
  }
};

}  // namespace

extern "C" {

// paths: NUL-separated, double-NUL-terminated list of shard files
// (raw little-endian uint32 tokens). Returns nullptr on failure.
void* seldon_loader_create(const char* paths, int64_t batch,
                           int64_t seq_len, uint64_t seed,
                           int64_t capacity) {
  auto* L = new Loader();
  L->batch = batch;
  L->seq_plus1 = seq_len + 1;
  L->seed = seed;
  L->capacity = capacity > 0 ? (size_t)capacity : 4;

  // Any failure must unmap/close every shard opened so far — a leaked
  // mapping+fd per retry would exhaust fds under flaky paths.
  auto fail = [L]() -> void* {
    for (auto& s : L->shards) {
      munmap((void*)s.data, s.mapped_bytes);
      close(s.fd);
    }
    delete L;
    return nullptr;
  };

  const char* p = paths;
  while (*p) {
    std::string path(p);
    p += path.size() + 1;
    int fd = open(path.c_str(), O_RDONLY);
    if (fd < 0) return fail();
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size < 4) {
      close(fd);
      return fail();
    }
    void* m = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (m == MAP_FAILED) {
      close(fd);
      return fail();
    }
    Shard s;
    s.data = (const uint32_t*)m;
    s.n_tokens = (size_t)st.st_size / 4;
    s.mapped_bytes = (size_t)st.st_size;
    s.fd = fd;
    L->shards.push_back(s);
    L->total_tokens += s.n_tokens;
  }
  if (L->total_tokens < (size_t)L->seq_plus1 + 1) return fail();
  L->ring.assign(L->capacity,
                 std::vector<int32_t>((size_t)(batch * L->seq_plus1)));
  L->worker = std::thread([L] { L->run(); });
  return L;
}

// Blocks until a prefetched batch is ready; copies [batch, seq_len+1] int32.
void seldon_loader_next(void* handle, int32_t* out) {
  auto* L = (Loader*)handle;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_empty.wait(lk, [&] { return L->count > 0; });
  auto& slot = L->ring[L->head];
  std::memcpy(out, slot.data(), slot.size() * sizeof(int32_t));
  L->head = (L->head + 1) % L->capacity;
  --L->count;
  L->cv_full.notify_one();
}

int64_t seldon_loader_total_tokens(void* handle) {
  return (int64_t)((Loader*)handle)->total_tokens;
}

void seldon_loader_destroy(void* handle) {
  auto* L = (Loader*)handle;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop.store(true);
  }
  L->cv_full.notify_all();
  L->cv_empty.notify_all();
  if (L->worker.joinable()) L->worker.join();
  for (auto& s : L->shards) {
    munmap((void*)s.data, s.mapped_bytes);
    close(s.fd);
  }
  delete L;
}

}  // extern "C"
