// Native host runtime: .flo codec + threaded prefetching loader.
//
// The reference pipeline is IO-bound on the host side (per-frame .flo reads,
// PNG decodes feeding the device; see SURVEY.md §5 "host-device pipeline").
// This library provides:
//   * flo_probe/flo_read/flo_write  — Middlebury .flo codec (C, zero-copy
//     into caller-provided buffers)
//   * flo_read_batch                — thread-pooled batch reader
//   * prefetcher_*                  — bounded-queue background reader that
//     overlaps disk IO with device compute (double/triple buffering)
//
// C ABI only (consumed via ctypes); no Python.h dependency.
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread loader.cpp -o _native_loader.so

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr float kFloMagic = 202021.25f;

struct FloHeader {
  float magic;
  int32_t width;
  int32_t height;
};

int read_flo_file(const char* path, float* out, int expect_w, int expect_h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  FloHeader hdr;
  if (std::fread(&hdr, sizeof(hdr), 1, f) != 1 || hdr.magic != kFloMagic) {
    std::fclose(f);
    return -2;
  }
  if (hdr.width != expect_w || hdr.height != expect_h) {
    std::fclose(f);
    return -3;
  }
  size_t count = static_cast<size_t>(hdr.width) * hdr.height * 2;
  size_t got = std::fread(out, sizeof(float), count, f);
  std::fclose(f);
  if (got < count) {
    // truncated payload: zero the tail for defined contents, but REPORT the
    // failure — a silently zero-filled flow frame corrupts detection
    std::memset(out + got, 0, (count - got) * sizeof(float));
    return -4;
  }
  return 0;
}

}  // namespace

extern "C" {

// Probe dimensions: returns 0 on success, fills w/h.
int flo_probe(const char* path, int* w, int* h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  FloHeader hdr;
  int ok = std::fread(&hdr, sizeof(hdr), 1, f) == 1 && hdr.magic == kFloMagic;
  std::fclose(f);
  if (!ok) return -2;
  *w = hdr.width;
  *h = hdr.height;
  return 0;
}

// Read one file into out (size h*w*2 floats). Returns 0 on success.
int flo_read(const char* path, float* out, int w, int h) {
  return read_flo_file(path, out, w, h);
}

int flo_write(const char* path, const float* data, int w, int h) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  FloHeader hdr{kFloMagic, w, h};
  std::fwrite(&hdr, sizeof(hdr), 1, f);
  size_t count = static_cast<size_t>(w) * h * 2;
  size_t wrote = std::fwrite(data, sizeof(float), count, f);
  std::fclose(f);
  return wrote == count ? 0 : -2;
}

// Batch read with a thread pool. paths: n C strings; out: n*h*w*2 floats.
// Returns number of files read successfully.
int flo_read_batch(const char** paths, int n, float* out, int w, int h,
                   int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next{0};
  std::atomic<int> ok_count{0};
  size_t stride = static_cast<size_t>(w) * h * 2;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      if (read_flo_file(paths[i], out + stride * i, w, h) == 0) {
        ok_count.fetch_add(1);
      } else {
        std::memset(out + stride * i, 0, stride * sizeof(float));
      }
    }
  };

  std::vector<std::thread> threads;
  int spawn = n_threads < n ? n_threads : n;
  threads.reserve(spawn);
  for (int t = 0; t < spawn; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return ok_count.load();
}

// ------------------------------------------------------------- prefetcher
struct Prefetcher {
  std::vector<std::string> paths;
  int width = 0, height = 0;
  size_t stride = 0;
  int depth = 0;

  struct Item {
    int idx;
    int err;  // read_flo_file return code (0 = ok)
    std::vector<float> buf;
  };

  std::mutex mu;
  std::condition_variable cv_space, cv_data;
  // slots filled in order; consumer takes front
  std::queue<Item> ready;
  int produced = 0;  // next index a producer will claim
  int consumed = 0;  // next index the consumer expects
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;

  // strict in-order delivery: workers park out-of-order results here
  std::vector<Item> parked;
};

void* prefetcher_create(const char** paths, int n, int w, int h, int depth,
                        int n_threads) {
  auto* p = new Prefetcher();
  p->paths.reserve(n);
  for (int i = 0; i < n; ++i) p->paths.emplace_back(paths[i]);
  p->width = w;
  p->height = h;
  p->stride = static_cast<size_t>(w) * h * 2;
  p->depth = depth < 1 ? 2 : depth;
  if (n_threads < 1) n_threads = 1;

  // Memory bound: a worker may only CLAIM an index while fewer than `depth`
  // indices are outstanding (claimed but not yet consumed). Claimed indices
  // are contiguous, so the in-order drain below can never deadlock on a
  // missing index — the bound applies at claim time, not at delivery time.
  auto worker = [p]() {
    for (;;) {
      int idx;
      {
        std::unique_lock<std::mutex> lk(p->mu);
        p->cv_space.wait(lk, [p] {
          return p->stop.load() ||
                 p->produced >= static_cast<int>(p->paths.size()) ||
                 p->produced < p->consumed + p->depth;
        });
        if (p->stop.load() ||
            p->produced >= static_cast<int>(p->paths.size()))
          return;
        idx = p->produced++;
      }
      std::vector<float> buf(p->stride);
      int err =
          read_flo_file(p->paths[idx].c_str(), buf.data(), p->width, p->height);
      std::unique_lock<std::mutex> lk(p->mu);
      if (p->stop.load()) return;
      p->parked.push_back(Prefetcher::Item{idx, err, std::move(buf)});
      // drain parked entries that are next in order
      bool moved = true;
      while (moved) {
        moved = false;
        for (auto it = p->parked.begin(); it != p->parked.end(); ++it) {
          int front_next =
              p->consumed + static_cast<int>(p->ready.size());
          if (it->idx == front_next) {
            p->ready.push(std::move(*it));
            p->parked.erase(it);
            moved = true;
            break;
          }
        }
      }
      p->cv_data.notify_all();
    }
  };
  int spawn = n_threads < n ? n_threads : (n > 0 ? n : 1);
  for (int t = 0; t < spawn; ++t) p->workers.emplace_back(worker);
  return p;
}

// Blocks until the next in-order flow field is ready; copies into out.
// Returns the index delivered, -1 when the sequence is exhausted, or
// (-2 - index) when reading that file FAILED (missing/corrupt/mismatched
// dimensions/truncated) — the buffer is zero-backed in that case and the
// caller must raise rather than treat it as flow.
int prefetcher_next(void* handle, float* out) {
  auto* p = static_cast<Prefetcher*>(handle);
  if (p->consumed >= static_cast<int>(p->paths.size())) return -1;
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_data.wait(lk, [p] { return p->stop.load() || !p->ready.empty(); });
  if (p->ready.empty()) return -1;
  auto item = std::move(p->ready.front());
  p->ready.pop();
  p->consumed = item.idx + 1;
  lk.unlock();
  p->cv_space.notify_all();
  std::memcpy(out, item.buf.data(), p->stride * sizeof(float));
  return item.err == 0 ? item.idx : -2 - item.idx;
}

// Outstanding (claimed-but-unconsumed) indices; bounded by `depth`.
int prefetcher_inflight(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  std::lock_guard<std::mutex> lk(p->mu);
  return p->produced - p->consumed;
}

void prefetcher_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  p->stop.store(true);
  p->cv_data.notify_all();
  p->cv_space.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
