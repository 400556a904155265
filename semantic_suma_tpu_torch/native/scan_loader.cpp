// Native KITTI scan loader: background-prefetching .bin reader.
//
// Replaces the reference's reader-side ring buffer
// (the reference's src/io/KITTIReader.cpp:51-130, rv::RingBuffer) with a
// C++ worker thread that reads ahead of the SLAM loop, so disk latency
// overlaps with TPU compute. Exposed to Python via a C ABI (ctypes).
//
// Contract: scans are KITTI velodyne .bin files, Nx4 float32 rows
// (x, y, z, remission). read() returns a pointer to an internally-owned
// buffer that stays valid until the next read() for the same slot cycles
// the ring (slots = prefetch_depth + 1 >= 2, so the last result is always
// safe while the next is being fetched).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Slot {
  std::vector<float> data;
  int64_t index = -1;   // scan index held, -1 = empty
  bool ready = false;
};

struct Loader {
  std::vector<std::string> paths;
  std::vector<Slot> slots;
  std::mutex mu;
  std::condition_variable cv_worker;   // wake worker: new target
  std::condition_variable cv_reader;   // wake reader: slot ready
  int64_t target = 0;                  // next index the consumer wants
  std::atomic<bool> stop{false};
  std::thread worker;
  int depth;

  explicit Loader(std::vector<std::string> p, int prefetch_depth)
      : paths(std::move(p)),
        slots(prefetch_depth + 1),
        depth(prefetch_depth) {
    worker = std::thread([this] { this->run(); });
  }

  ~Loader() {
    stop.store(true);
    cv_worker.notify_all();
    if (worker.joinable()) worker.join();
  }

  Slot* slot_for(int64_t idx) { return &slots[idx % slots.size()]; }

  static bool read_file(const std::string& path, std::vector<float>* out) {
    FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    out->resize(static_cast<size_t>(size) / sizeof(float));
    size_t got = std::fread(out->data(), 1, static_cast<size_t>(size), f);
    std::fclose(f);
    return got == static_cast<size_t>(size);
  }

  void run() {
    std::unique_lock<std::mutex> lk(mu);
    while (!stop.load()) {
      // find the next index in [target, target+depth-1] not yet loaded.
      // The window is `depth` wide while the ring has depth+1 slots, so the
      // consumer's most-recent result (slot of target-1) is never recycled
      // while Python still holds its pointer.
      int64_t todo = -1;
      for (int64_t i = target;
           i < target + depth && i < static_cast<int64_t>(paths.size());
           ++i) {
        Slot* s = slot_for(i);
        if (s->index != i || !s->ready) {
          todo = i;
          break;
        }
      }
      if (todo < 0) {
        cv_worker.wait(lk);
        continue;
      }
      Slot* s = slot_for(todo);
      s->index = todo;
      s->ready = false;
      std::vector<float> buf;
      lk.unlock();
      bool ok = read_file(paths[static_cast<size_t>(todo)], &buf);
      lk.lock();
      // the target may have moved while reading; only commit if still wanted
      if (s->index == todo) {
        s->data = std::move(buf);
        s->ready = ok;
        if (!ok) s->data.clear();
        cv_reader.notify_all();
      }
    }
  }

  // Blocks until scan idx is available; returns pointer + float count.
  const float* read(int64_t idx, int64_t* count) {
    std::unique_lock<std::mutex> lk(mu);
    if (idx < 0 || idx >= static_cast<int64_t>(paths.size())) {
      *count = 0;
      return nullptr;
    }
    target = idx;
    Slot* s = slot_for(idx);
    if (s->index != idx) {  // random seek: invalidate and refetch
      s->index = idx;
      s->ready = false;
    }
    cv_worker.notify_all();
    cv_reader.wait(lk, [&] { return (s->index == idx && s->ready) ||
                                    stop.load(); });
    target = idx + 1;  // let the worker run ahead
    cv_worker.notify_all();
    *count = static_cast<int64_t>(s->data.size());
    return s->data.data();
  }
};

}  // namespace

extern "C" {

void* scan_loader_create(const char** paths, int64_t n_paths,
                         int prefetch_depth) {
  std::vector<std::string> p;
  p.reserve(static_cast<size_t>(n_paths));
  for (int64_t i = 0; i < n_paths; ++i) p.emplace_back(paths[i]);
  if (prefetch_depth < 1) prefetch_depth = 1;
  return new Loader(std::move(p), prefetch_depth);
}

const float* scan_loader_read(void* handle, int64_t idx, int64_t* count) {
  return static_cast<Loader*>(handle)->read(idx, count);
}

void scan_loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
