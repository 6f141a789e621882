// Host-side prefetch pipeline: background readers + bounded slab queue.
//
// Native counterpart of the reference's PartialH5Dataset thread machinery
// (heat/utils/data/partial_dataset.py:32,224): there Python threads read
// HDF5 slabs into a conversion queue; here a C++ reader thread streams
// byte slabs of any file through a condition-variable-bounded ring so the
// Python consumer (which copies them to the device) never blocks on disk.

#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <mutex>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>

namespace {

struct Slab {
  char* data;
  long size;
};

struct Pipeline {
  int fd = -1;
  long pos = 0;
  long end = 0;
  long slab_bytes = 0;
  int depth = 2;
  bool failed = false;
  bool done = false;
  std::deque<Slab> queue;
  std::mutex mu;
  std::condition_variable cv_put;
  std::condition_variable cv_get;
  std::thread reader;

  void run() {
    while (true) {
      long n = end - pos;
      if (n <= 0) break;
      if (n > slab_bytes) n = slab_bytes;
      char* buf = (char*)malloc(n);
      if (!buf) {
        std::lock_guard<std::mutex> g(mu);
        failed = true;
        break;
      }
      long off = 0;
      while (off < n) {
        ssize_t r = pread(fd, buf + off, n - off, pos + off);
        if (r <= 0) break;
        off += r;
      }
      if (off != n) {
        free(buf);
        std::lock_guard<std::mutex> g(mu);
        failed = true;
        break;
      }
      pos += n;
      std::unique_lock<std::mutex> lk(mu);
      cv_put.wait(lk, [&] { return (int)queue.size() < depth || done; });
      if (done) {  // consumer closed early
        free(buf);
        break;
      }
      queue.push_back({buf, n});
      cv_get.notify_one();
    }
    std::lock_guard<std::mutex> g(mu);
    done = true;
    cv_get.notify_all();
  }
};

}  // namespace

extern "C" {

void* ht_prefetch_open(const char* path, long offset, long nbytes,
                       long slab_bytes, int depth) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  Pipeline* p = new Pipeline();
  p->fd = fd;
  p->pos = offset;
  long limit = (nbytes < 0) ? (long)st.st_size : offset + nbytes;
  p->end = limit < (long)st.st_size ? limit : (long)st.st_size;
  p->slab_bytes = slab_bytes > 0 ? slab_bytes : (8 << 20);
  p->depth = depth > 0 ? depth : 2;
  p->reader = std::thread([p] { p->run(); });
  return p;
}

// Copy the next slab into out (capacity cap). Returns bytes copied, 0 at
// end-of-stream, -1 on reader failure or undersized buffer.
long ht_prefetch_next(void* handle, void* out, long cap) {
  Pipeline* p = (Pipeline*)handle;
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_get.wait(lk, [&] { return !p->queue.empty() || p->done || p->failed; });
  if (p->queue.empty()) return p->failed ? -1 : 0;
  Slab s = p->queue.front();
  if (s.size > cap) return -1;
  p->queue.pop_front();
  p->cv_put.notify_one();
  lk.unlock();
  memcpy(out, s.data, s.size);
  free(s.data);
  return s.size;
}

void ht_prefetch_close(void* handle) {
  Pipeline* p = (Pipeline*)handle;
  {
    std::lock_guard<std::mutex> g(p->mu);
    p->done = true;
    p->cv_put.notify_all();
    p->cv_get.notify_all();
  }
  if (p->reader.joinable()) p->reader.join();
  for (auto& s : p->queue) free(s.data);
  close(p->fd);
  delete p;
}

}  // extern "C"
