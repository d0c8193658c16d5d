// Native host runtime for paddle_tpu_torch (a copy of paddle_tpu's).
//
// Analogue of the reference's C++ reader stack
// (ref: paddle/fluid/operators/reader/blocking_queue.h,
//  paddle/fluid/framework/blocking_queue.h, operators/reader/
//  buffered_reader.cc) and host memory arena
// (ref: paddle/fluid/memory/allocation/pinned_allocator.cc).
//
// Three layers, all exported C ABI for ctypes:
//
// - ptq_*: bounded MPMC token queue with condition-variable blocking.
//   Python keeps arbitrary batch objects; tokens flow through C++ so
//   producers block/wake without the GIL.
//
// - arena_*: bump-pointer staging arena, 64-byte aligned, mlock()ed on a
//   best-effort basis (the host transfer path reads from here; locking
//   avoids page faults mid-transfer).
//
// - pipe_*: the actual batch pipeline. A ring of fixed-size arena slots +
//   a copy worker pool. Producers acquire a slot, submit memcpy jobs (the
//   copies run on C++ worker threads — and ctypes releases the GIL, so
//   staging overlaps the consumer's device step), commit, and consumers
//   map the slot's bytes zero-copy as numpy views. Back-pressure is the
//   ring itself: acquire_write blocks while every slot is in flight.
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

#if defined(__unix__) || defined(__APPLE__)
#include <sys/mman.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// token queue
// ---------------------------------------------------------------------------
struct TokenQueue {
  std::deque<long> items;
  std::mutex mu;
  std::condition_variable not_empty;
  std::condition_variable not_full;
  size_t capacity;
};

void* ptq_create(int capacity) {
  auto* q = new TokenQueue();
  q->capacity = capacity > 0 ? static_cast<size_t>(capacity) : 1;
  return q;
}

void ptq_put(void* handle, long token) {
  auto* q = static_cast<TokenQueue*>(handle);
  std::unique_lock<std::mutex> lk(q->mu);
  q->not_full.wait(lk, [q] { return q->items.size() < q->capacity; });
  q->items.push_back(token);
  q->not_empty.notify_one();
}

long ptq_get(void* handle) {
  auto* q = static_cast<TokenQueue*>(handle);
  std::unique_lock<std::mutex> lk(q->mu);
  q->not_empty.wait(lk, [q] { return !q->items.empty(); });
  long t = q->items.front();
  q->items.pop_front();
  q->not_full.notify_one();
  return t;
}

void ptq_destroy(void* handle) { delete static_cast<TokenQueue*>(handle); }

// ---------------------------------------------------------------------------
// arena
// ---------------------------------------------------------------------------
struct Arena {
  char* base;
  size_t size;
  size_t offset;
  bool locked;
};

void* arena_create(size_t bytes) {
  auto* a = new Arena();
  a->base = static_cast<char*>(::operator new(bytes, std::align_val_t(64)));
  a->size = bytes;
  a->offset = 0;
  a->locked = false;
#if defined(__unix__) || defined(__APPLE__)
  // best-effort pinning (needs CAP_IPC_LOCK / rlimit; falls back silently)
  a->locked = (mlock(a->base, bytes) == 0);
#endif
  return a;
}

int arena_is_locked(void* handle) {
  return static_cast<Arena*>(handle)->locked ? 1 : 0;
}

void* arena_alloc(void* handle, size_t bytes) {
  auto* a = static_cast<Arena*>(handle);
  size_t aligned = (bytes + 63) & ~size_t(63);
  if (a->offset + aligned > a->size) return nullptr;
  void* p = a->base + a->offset;
  a->offset += aligned;
  return p;
}

void arena_reset(void* handle) { static_cast<Arena*>(handle)->offset = 0; }

void arena_destroy(void* handle) {
  auto* a = static_cast<Arena*>(handle);
#if defined(__unix__) || defined(__APPLE__)
  if (a->locked) munlock(a->base, a->size);
#endif
  ::operator delete(a->base, std::align_val_t(64));
  delete a;
}

// ---------------------------------------------------------------------------
// batch pipe: slot ring + copy worker pool
// ---------------------------------------------------------------------------
enum SlotState { SLOT_FREE = 0, SLOT_WRITING = 1, SLOT_READY = 2,
                 SLOT_READING = 3 };

struct CopyJob {
  char* dst;
  const char* src;
  size_t n;
  int slot;
};

struct BatchPipe {
  void* arena;
  char* base;              // arena-backed slab, capacity * slot_bytes
  size_t slot_bytes;
  int capacity;
  std::vector<int> state;            // SlotState per slot
  std::vector<int> pending_copies;   // outstanding jobs per slot
  std::deque<int> ready;             // committed slot ids, FIFO
  std::mutex mu;
  std::condition_variable cv;        // slot state changes
  bool aborting = false;             // wakes ring waiters with -1
  // worker pool
  std::vector<std::thread> workers;
  std::deque<CopyJob> jobs;
  std::mutex job_mu;
  std::condition_variable job_cv;
  bool stopping = false;
};

static void pipe_worker(BatchPipe* p) {
  for (;;) {
    CopyJob job;
    {
      std::unique_lock<std::mutex> lk(p->job_mu);
      p->job_cv.wait(lk, [p] { return p->stopping || !p->jobs.empty(); });
      if (p->stopping && p->jobs.empty()) return;
      job = p->jobs.front();
      p->jobs.pop_front();
    }
    std::memcpy(job.dst, job.src, job.n);
    {
      std::lock_guard<std::mutex> lk(p->mu);
      p->pending_copies[job.slot]--;
    }
    p->cv.notify_all();
  }
}

void* pipe_create(int capacity, size_t slot_bytes, int n_workers) {
  auto* p = new BatchPipe();
  p->capacity = capacity > 0 ? capacity : 2;
  p->slot_bytes = slot_bytes;
  p->arena = arena_create(static_cast<size_t>(p->capacity) * slot_bytes);
  p->base = static_cast<char*>(
      arena_alloc(p->arena, static_cast<size_t>(p->capacity) * slot_bytes));
  p->state.assign(p->capacity, SLOT_FREE);
  p->pending_copies.assign(p->capacity, 0);
  if (n_workers < 1) n_workers = 1;
  for (int i = 0; i < n_workers; ++i)
    p->workers.emplace_back(pipe_worker, p);
  return p;
}

int pipe_is_pinned(void* handle) {
  return arena_is_locked(static_cast<BatchPipe*>(handle)->arena);
}

// producer: block until a slot is free, mark it writing; -1 when aborted
int pipe_acquire_write(void* handle) {
  auto* p = static_cast<BatchPipe*>(handle);
  std::unique_lock<std::mutex> lk(p->mu);
  int slot = -1;
  p->cv.wait(lk, [p, &slot] {
    if (p->aborting) return true;
    for (int i = 0; i < p->capacity; ++i)
      if (p->state[i] == SLOT_FREE) { slot = i; return true; }
    return false;
  });
  if (p->aborting || slot < 0) return -1;
  p->state[slot] = SLOT_WRITING;
  return slot;
}

// unblock every ring waiter (they return -1); the pipe stays allocated so
// in-flight pipe_* calls stay valid — call pipe_destroy only after the
// producer/consumer threads have observed the abort and stopped
void pipe_abort(void* handle) {
  auto* p = static_cast<BatchPipe*>(handle);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->aborting = true;
  }
  p->cv.notify_all();
}

// re-arm an aborted pipe for a fresh epoch (slots reset to FREE; any
// committed-but-unread batches are dropped)
void pipe_reset(void* handle) {
  auto* p = static_cast<BatchPipe*>(handle);
  std::lock_guard<std::mutex> lk(p->mu);
  p->aborting = false;
  p->ready.clear();
  for (int i = 0; i < p->capacity; ++i) p->state[i] = SLOT_FREE;
}

void* pipe_slot_ptr(void* handle, int slot) {
  auto* p = static_cast<BatchPipe*>(handle);
  return p->base + static_cast<size_t>(slot) * p->slot_bytes;
}

// synchronous staging copy (the GIL is released while this runs)
void pipe_write(void* handle, int slot, size_t offset, const void* src,
                size_t n) {
  auto* p = static_cast<BatchPipe*>(handle);
  std::memcpy(p->base + static_cast<size_t>(slot) * p->slot_bytes + offset,
              src, n);
}

// async staging: enqueue to the worker pool; the caller must keep src
// alive until pipe_wait_writes(slot) returns
void pipe_submit_write(void* handle, int slot, size_t offset,
                       const void* src, size_t n) {
  auto* p = static_cast<BatchPipe*>(handle);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->pending_copies[slot]++;
  }
  {
    std::lock_guard<std::mutex> lk(p->job_mu);
    p->jobs.push_back(CopyJob{
        p->base + static_cast<size_t>(slot) * p->slot_bytes + offset,
        static_cast<const char*>(src), n, slot});
  }
  p->job_cv.notify_one();
}

void pipe_wait_writes(void* handle, int slot) {
  auto* p = static_cast<BatchPipe*>(handle);
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv.wait(lk, [p, slot] { return p->pending_copies[slot] == 0; });
}

void pipe_commit(void* handle, int slot) {
  auto* p = static_cast<BatchPipe*>(handle);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->state[slot] = SLOT_READY;
    p->ready.push_back(slot);
  }
  p->cv.notify_all();
}

// consumer: block until a committed slot is available (FIFO); -1 on abort
int pipe_acquire_read(void* handle) {
  auto* p = static_cast<BatchPipe*>(handle);
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv.wait(lk, [p] { return p->aborting || !p->ready.empty(); });
  if (p->ready.empty()) return -1;
  int slot = p->ready.front();
  p->ready.pop_front();
  p->state[slot] = SLOT_READING;
  return slot;
}

void pipe_release(void* handle, int slot) {
  auto* p = static_cast<BatchPipe*>(handle);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->state[slot] = SLOT_FREE;
  }
  p->cv.notify_all();
}

void pipe_destroy(void* handle) {
  auto* p = static_cast<BatchPipe*>(handle);
  {
    std::lock_guard<std::mutex> lk(p->job_mu);
    p->stopping = true;
  }
  p->job_cv.notify_all();
  for (auto& t : p->workers) t.join();
  arena_destroy(p->arena);
  delete p;
}

}  // extern "C"
