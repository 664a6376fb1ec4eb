// Chrome-trace timeline writer with a dedicated writer thread.
//
// Native redesign of the reference Timeline (horovod/common/timeline.cc:
// TimelineWriter + boost lockfree SPSC queue + writer thread; activity
// span model documented at common.h:83-116). Events are enqueued from the
// hot path into a bounded MPSC ring; a writer thread drains to
// about:tracing JSON. Dropped-on-overflow, never blocking the caller.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace hvdn {

struct Event {
  char name[64];
  char cat[24];  // for phase 'C': the counter series name (args key)
  char phase;  // 'B' begin, 'E' end, 'X' complete, 'i' instant, 'M' meta,
               // 'C' counter
  int64_t ts_us;
  int64_t dur_us;
  int32_t pid;
  int32_t tid;
  double value;  // phase 'C' only
};

class Timeline {
 public:
  Timeline(const char* path, size_t capacity = 1 << 16)
      : capacity_(capacity), ring_(capacity) {
    f_ = std::fopen(path, "w");
    if (f_ == nullptr) return;
    std::fputs("[\n", f_);
    writer_ = std::thread([this] { WriterLoop(); });
  }

  ~Timeline() { Close(); }

  bool ok() const { return f_ != nullptr; }

  bool Emit(const Event& e) {
    std::unique_lock<std::mutex> g(mu_);
    size_t next = (head_ + 1) % capacity_;
    if (next == tail_) return false;  // full: drop (never block hot path)
    ring_[head_] = e;
    head_ = next;
    g.unlock();
    cv_.notify_one();
    return true;
  }

  void Close() {
    bool expected = false;
    if (!closing_.compare_exchange_strong(expected, true)) return;
    cv_.notify_all();
    if (writer_.joinable()) writer_.join();
    if (f_ != nullptr) {
      std::fputs("]\n", f_);
      std::fclose(f_);
      f_ = nullptr;
    }
  }

 private:
  void WriterLoop() {
    bool first = true;
    while (true) {
      std::unique_lock<std::mutex> g(mu_);
      cv_.wait_for(g, std::chrono::milliseconds(100),
                   [this] { return head_ != tail_ || closing_.load(); });
      bool drained = false;
      while (tail_ != head_) {
        Event e = ring_[tail_];
        tail_ = (tail_ + 1) % capacity_;
        g.unlock();
        WriteEvent(e, first);
        first = false;
        drained = true;
        g.lock();
      }
      if (drained) {
        // Durability: push the batch into the OS page cache so a
        // SIGKILL'd run still leaves a loadable (truncated-array) trace.
        std::fflush(f_);
      }
      if (closing_.load() && head_ == tail_) break;
    }
  }

  static void JsonEscape(const char* in, char* out, size_t outcap) {
    size_t j = 0;
    for (size_t i = 0; in[i] != '\0' && j + 2 < outcap; ++i) {
      char c = in[i];
      if (c == '"' || c == '\\') out[j++] = '\\';
      if (static_cast<unsigned char>(c) < 0x20) c = ' ';
      out[j++] = c;
    }
    out[j] = '\0';
  }

  void WriteEvent(const Event& e, bool first) {
    char name[140], cat[56];
    JsonEscape(e.name, name, sizeof(name));
    JsonEscape(e.cat, cat, sizeof(cat));
    if (!first) std::fputs(",\n", f_);
    if (e.phase == 'C') {
      std::fprintf(f_,
                   "{\"name\":\"%s\",\"ph\":\"C\",\"ts\":%lld,"
                   "\"pid\":%d,\"args\":{\"%s\":%.17g}}",
                   name, static_cast<long long>(e.ts_us), e.pid, cat,
                   e.value);
    } else if (e.phase == 'X') {
      std::fprintf(f_,
                   "{\"name\":\"%s\",\"cat\":\"%s\",\"ph\":\"X\","
                   "\"ts\":%lld,\"dur\":%lld,\"pid\":%d,\"tid\":%d}",
                   name, cat, static_cast<long long>(e.ts_us),
                   static_cast<long long>(e.dur_us), e.pid, e.tid);
    } else {
      std::fprintf(f_,
                   "{\"name\":\"%s\",\"cat\":\"%s\",\"ph\":\"%c\","
                   "\"ts\":%lld,\"pid\":%d,\"tid\":%d}",
                   name, cat, e.phase, static_cast<long long>(e.ts_us),
                   e.pid, e.tid);
    }
  }

  size_t capacity_;
  std::vector<Event> ring_;
  size_t head_ = 0, tail_ = 0;
  std::mutex mu_;
  std::condition_variable cv_;
  std::atomic<bool> closing_{false};
  std::FILE* f_ = nullptr;
  std::thread writer_;
};

}  // namespace hvdn

extern "C" {

void* hvdn_timeline_open(const char* path) {
  auto* t = new hvdn::Timeline(path);
  if (!t->ok()) {
    delete t;
    return nullptr;
  }
  return t;
}

int hvdn_timeline_emit(void* h, const char* name, const char* cat, char phase,
                       long long ts_us, long long dur_us, int pid, int tid) {
  hvdn::Event e{};
  std::snprintf(e.name, sizeof(e.name), "%s", name);
  std::snprintf(e.cat, sizeof(e.cat), "%s", cat);
  e.phase = phase;
  e.ts_us = ts_us;
  e.dur_us = dur_us;
  e.pid = pid;
  e.tid = tid;
  return static_cast<hvdn::Timeline*>(h)->Emit(e) ? 0 : -1;
}

int hvdn_timeline_emit_counter(void* h, const char* name, const char* series,
                               double value, long long ts_us) {
  hvdn::Event e{};
  std::snprintf(e.name, sizeof(e.name), "%s", name);
  std::snprintf(e.cat, sizeof(e.cat), "%s", series);
  e.phase = 'C';
  e.ts_us = ts_us;
  e.value = value;
  return static_cast<hvdn::Timeline*>(h)->Emit(e) ? 0 : -1;
}

void hvdn_timeline_close(void* h) {
  auto* t = static_cast<hvdn::Timeline*>(h);
  t->Close();
  delete t;
}

}  // extern "C"
