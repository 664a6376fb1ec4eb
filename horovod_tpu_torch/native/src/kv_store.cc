// TCP key-value / coordination store.
//
// Native control plane for rendezvous, barriers, and bitvector cache
// coordination. Plays the role the reference's C++ control plane plays:
// the Gloo HTTP KV store (reference: horovod/common/gloo/http_store.cc,
// gloo_context rendezvous) and the controller's cross-rank bitwise
// AND/OR cache sync (reference: horovod/common/controller.cc:159-190
// CoordinateCacheAndState + CrossRankBitwiseAnd/Or).
//
// Wire protocol (binary, length-prefixed):
//   request : u8 op | u32 klen | key | u64 vlen | value
//   response: i64 status_or_len | payload
// Ops: 1=PUT 2=GET 3=ADD(i64 delta -> new value) 4=AND 5=OR
//      6=GETC (value returned only once `count >= expected`)
//      7=DEL  8=PING
// AND/OR combine byte arrays elementwise and track contributor count; GETC
// takes an 8-byte little-endian expected-count as its value and returns the
// combined bytes once enough ranks contributed (the 2-allreduce bitvector
// negotiation collapses to: every rank AND/ORs, then GETCs).

#include <arpa/inet.h>
#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace hvdn {

struct Entry {
  std::vector<uint8_t> value;
  int64_t count = 0;  // contributors (AND/OR) or monotonically bumped on PUT
};

class KVServer {
 public:
  explicit KVServer(int port) {
    listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    int one = 1;
    ::setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = INADDR_ANY;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (::bind(listen_fd_, reinterpret_cast<sockaddr*>(&addr),
               sizeof(addr)) != 0 ||
        ::listen(listen_fd_, 128) != 0) {
      ::close(listen_fd_);
      listen_fd_ = -1;
      return;
    }
    socklen_t len = sizeof(addr);
    ::getsockname(listen_fd_, reinterpret_cast<sockaddr*>(&addr), &len);
    port_ = ntohs(addr.sin_port);
    accept_thread_ = std::thread([this] { AcceptLoop(); });
  }

  ~KVServer() { Stop(); }

  int port() const { return port_; }
  bool ok() const { return listen_fd_ >= 0; }

  void Stop() {
    bool expected = false;
    if (!stopping_.compare_exchange_strong(expected, true)) return;
    if (listen_fd_ >= 0) {
      ::shutdown(listen_fd_, SHUT_RDWR);
      ::close(listen_fd_);
    }
    if (accept_thread_.joinable()) accept_thread_.join();
    // Serve threads may be blocked in recv() on idle client connections:
    // shut their fds down so they return. The shutdowns happen under
    // conn_mu_, where no Serve thread can close an fd (it deregisters
    // under conn_mu_ before it closes), so no fd number here has been
    // reused. The threads are taken out under the lock and joined after
    // it is released: a Serve thread on its way out takes conn_mu_ to
    // deregister, so joining it while holding conn_mu_ would deadlock.
    std::vector<std::thread> threads;
    {
      std::lock_guard<std::mutex> g(conn_mu_);
      for (int fd : conn_fds_) ::shutdown(fd, SHUT_RDWR);
      threads.swap(conn_threads_);
    }
    for (auto& t : threads)
      if (t.joinable()) t.join();
  }

 private:
  static bool ReadAll(int fd, void* buf, size_t n) {
    auto* p = static_cast<uint8_t*>(buf);
    while (n > 0) {
      ssize_t r = ::recv(fd, p, n, 0);
      if (r <= 0) return false;
      p += r;
      n -= static_cast<size_t>(r);
    }
    return true;
  }

  static bool WriteAll(int fd, const void* buf, size_t n) {
    auto* p = static_cast<const uint8_t*>(buf);
    while (n > 0) {
      ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
      if (r <= 0) return false;
      p += r;
      n -= static_cast<size_t>(r);
    }
    return true;
  }

  void AcceptLoop() {
    while (!stopping_.load()) {
      int fd = ::accept(listen_fd_, nullptr, nullptr);
      if (fd < 0) {
        if (stopping_.load()) break;
        continue;
      }
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      std::lock_guard<std::mutex> g(conn_mu_);
      conn_fds_.push_back(fd);
      conn_threads_.emplace_back([this, fd] { Serve(fd); });
    }
  }

  void Serve(int fd) {
    while (!stopping_.load()) {
      uint8_t op;
      uint32_t klen;
      uint64_t vlen;
      if (!ReadAll(fd, &op, 1) || !ReadAll(fd, &klen, 4) ||
          klen > (1u << 20))
        break;
      std::string key(klen, '\0');
      if (!ReadAll(fd, key.data(), klen) || !ReadAll(fd, &vlen, 8) ||
          vlen > (1ull << 32))
        break;
      std::vector<uint8_t> val(vlen);
      if (vlen && !ReadAll(fd, val.data(), vlen)) break;

      int64_t status = 0;
      std::vector<uint8_t> payload;
      {
        std::lock_guard<std::mutex> g(mu_);
        switch (op) {
          case 1: {  // PUT
            auto& e = store_[key];
            e.value = std::move(val);
            e.count += 1;
            break;
          }
          case 2: {  // GET
            auto it = store_.find(key);
            if (it == store_.end()) {
              status = -1;
            } else {
              payload = it->second.value;
              status = static_cast<int64_t>(payload.size());
            }
            break;
          }
          case 3: {  // ADD
            int64_t delta = 0;
            if (val.size() == 8) std::memcpy(&delta, val.data(), 8);
            auto& e = store_[key];
            if (e.value.size() != 8) e.value.assign(8, 0);
            int64_t cur;
            std::memcpy(&cur, e.value.data(), 8);
            cur += delta;
            std::memcpy(e.value.data(), &cur, 8);
            e.count += 1;
            status = cur;
            break;
          }
          case 4:    // AND
          case 5: {  // OR
            auto& e = store_[key];
            if (e.value.empty()) {
              e.value = val;
            } else if (e.value.size() == val.size()) {
              for (size_t i = 0; i < val.size(); ++i)
                e.value[i] = (op == 4) ? (e.value[i] & val[i])
                                       : (e.value[i] | val[i]);
            } else {
              status = -2;  // size mismatch
              break;
            }
            e.count += 1;
            status = e.count;
            break;
          }
          case 6: {  // GETC
            int64_t expected = 0;
            if (val.size() == 8) std::memcpy(&expected, val.data(), 8);
            auto it = store_.find(key);
            if (it == store_.end() || it->second.count < expected) {
              status = -1;  // not ready
            } else {
              payload = it->second.value;
              status = static_cast<int64_t>(payload.size());
            }
            break;
          }
          case 7:  // DEL
            store_.erase(key);
            break;
          case 8:  // PING
            status = 42;
            break;
          default:
            status = -3;
        }
      }
      if (!WriteAll(fd, &status, 8)) break;
      if (status > 0 && !payload.empty() &&
          !WriteAll(fd, payload.data(), payload.size()))
        break;
    }
    // Deregister BEFORE close: once closed the fd number can be reused by
    // an unrelated descriptor, and a stale entry would make Stop()'s
    // shutdown() tear down that stranger's socket. (Also keeps conn_fds_
    // from growing for the lifetime of a long launcher.)
    {
      std::lock_guard<std::mutex> g(conn_mu_);
      conn_fds_.erase(std::remove(conn_fds_.begin(), conn_fds_.end(), fd),
                      conn_fds_.end());
    }
    ::close(fd);
  }

  int listen_fd_ = -1;
  int port_ = 0;
  std::atomic<bool> stopping_{false};
  std::thread accept_thread_;
  std::mutex conn_mu_;
  std::vector<int> conn_fds_;
  std::vector<std::thread> conn_threads_;
  std::mutex mu_;
  std::map<std::string, Entry> store_;
};

class KVClient {
 public:
  KVClient(const char* host, int port) {
    fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    ::inet_pton(AF_INET, host, &addr.sin_addr);
    if (::connect(fd_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) !=
        0) {
      ::close(fd_);
      fd_ = -1;
      return;
    }
    int one = 1;
    ::setsockopt(fd_, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  }

  ~KVClient() {
    if (fd_ >= 0) ::close(fd_);
  }

  bool ok() const { return fd_ >= 0; }

  // Returns status; fills out (resized) on GET-like ops.
  int64_t Request(uint8_t op, const std::string& key, const uint8_t* val,
                  uint64_t vlen, std::vector<uint8_t>* out) {
    std::lock_guard<std::mutex> g(mu_);
    if (fd_ < 0) return -100;
    uint32_t klen = static_cast<uint32_t>(key.size());
    if (!WriteAll(fd_, &op, 1) || !WriteAll(fd_, &klen, 4) ||
        !WriteAll(fd_, key.data(), klen) || !WriteAll(fd_, &vlen, 8) ||
        (vlen && !WriteAll(fd_, val, vlen)))
      return -100;
    int64_t status;
    if (!ReadAll(fd_, &status, 8)) return -100;
    if (status > 0 && out != nullptr && (op == 2 || op == 6)) {
      out->resize(static_cast<size_t>(status));
      if (!ReadAll(fd_, out->data(), out->size())) return -100;
    }
    return status;
  }

 private:
  static bool ReadAll(int fd, void* buf, size_t n) {
    auto* p = static_cast<uint8_t*>(buf);
    while (n > 0) {
      ssize_t r = ::recv(fd, p, n, 0);
      if (r <= 0) return false;
      p += r;
      n -= static_cast<size_t>(r);
    }
    return true;
  }
  static bool WriteAll(int fd, const void* buf, size_t n) {
    auto* p = static_cast<const uint8_t*>(buf);
    while (n > 0) {
      ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
      if (r <= 0) return false;
      p += r;
      n -= static_cast<size_t>(r);
    }
    return true;
  }

  int fd_ = -1;
  std::mutex mu_;
};

}  // namespace hvdn

extern "C" {

void* hvdn_kv_server_start(int port) {
  auto* s = new hvdn::KVServer(port);
  if (!s->ok()) {
    delete s;
    return nullptr;
  }
  return s;
}

int hvdn_kv_server_port(void* h) {
  return static_cast<hvdn::KVServer*>(h)->port();
}

void hvdn_kv_server_stop(void* h) {
  auto* s = static_cast<hvdn::KVServer*>(h);
  s->Stop();
  delete s;
}

void* hvdn_kv_client_new(const char* host, int port) {
  auto* c = new hvdn::KVClient(host, port);
  if (!c->ok()) {
    delete c;
    return nullptr;
  }
  return c;
}

void hvdn_kv_client_free(void* h) { delete static_cast<hvdn::KVClient*>(h); }

long long hvdn_kv_request(void* h, int op, const char* key,
                          const unsigned char* val, unsigned long long vlen,
                          unsigned char* out, unsigned long long outcap) {
  std::vector<uint8_t> payload;
  int64_t st = static_cast<hvdn::KVClient*>(h)->Request(
      static_cast<uint8_t>(op), key, val, vlen, &payload);
  if (st > 0 && out != nullptr) {
    uint64_t n = payload.size() < outcap ? payload.size() : outcap;
    std::memcpy(out, payload.data(), n);
  }
  return st;
}

}  // extern "C"
