// Stall inspector: detects collectives some ranks entered and others
// didn't.
//
// Native redesign of the reference StallInspector
// (horovod/common/stall_inspector.cc — coordinator warns at 60 s,
// stall_inspector.h:78, optional shutdown window). Here the bookkeeping is
// host-side: report_submit() when a named collective is entered,
// report_done() when it completes; check() returns the names outstanding
// longer than the warning threshold.

#include <chrono>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace hvdn {

class StallInspector {
 public:
  StallInspector(double warn_sec, double shutdown_sec)
      : warn_sec_(warn_sec), shutdown_sec_(shutdown_sec) {}

  void Submit(const std::string& name) {
    std::lock_guard<std::mutex> g(mu_);
    pending_.emplace(name, Now());
  }

  void Done(const std::string& name) {
    std::lock_guard<std::mutex> g(mu_);
    pending_.erase(name);
  }

  // Returns stalled names joined by '\n'; sets *shutdown if any exceeded
  // the shutdown window.
  std::string Check(int* shutdown) {
    std::lock_guard<std::mutex> g(mu_);
    double now = Now();
    std::string out;
    *shutdown = 0;
    for (const auto& [name, t0] : pending_) {
      double age = now - t0;
      if (age >= warn_sec_) {
        if (!out.empty()) out += '\n';
        out += name;
      }
      if (shutdown_sec_ > 0 && age >= shutdown_sec_) *shutdown = 1;
    }
    return out;
  }

 private:
  static double Now() {
    return std::chrono::duration<double>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  }

  double warn_sec_, shutdown_sec_;
  std::mutex mu_;
  std::map<std::string, double> pending_;
};

}  // namespace hvdn

extern "C" {

void* hvdn_stall_new(double warn_sec, double shutdown_sec) {
  return new hvdn::StallInspector(warn_sec, shutdown_sec);
}

void hvdn_stall_free(void* h) { delete static_cast<hvdn::StallInspector*>(h); }

void hvdn_stall_submit(void* h, const char* name) {
  static_cast<hvdn::StallInspector*>(h)->Submit(name);
}

void hvdn_stall_done(void* h, const char* name) {
  static_cast<hvdn::StallInspector*>(h)->Done(name);
}

// Writes '\n'-joined stalled names into buf; returns byte count (may be 0).
long long hvdn_stall_check(void* h, char* buf, long long cap, int* shutdown) {
  std::string s = static_cast<hvdn::StallInspector*>(h)->Check(shutdown);
  long long n = static_cast<long long>(s.size());
  if (buf != nullptr && cap > 0) {
    long long c = n < cap - 1 ? n : cap - 1;
    std::memcpy(buf, s.data(), static_cast<size_t>(c));
    buf[c] = '\0';
  }
  return n;
}

}  // extern "C"
