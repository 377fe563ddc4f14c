// dmmrt — native host runtime for the control loop (vendored unchanged in
// function from dnn_mppi_mpc_tpu/runtime/src/dmmrt.cpp; the card's port
// builds it with the host C++ compiler at first use, runtime/native.py).
//
// The reference's native layer exists to run control in real time (embedded
// acados SQP solvers in c_generated_code/, l4casadi C++ shims in
// _l4c_generated/). On the card the solver itself is a chain of kernel
// launches, so the native layer moves to where it still matters: the host
// side of the control loop. This library provides the three pieces a
// deployment loop needs to hit a p99 latency budget (BASELINE.md, 50 Hz)
// without Python-level jitter:
//
//   1. rate pacer      — absolute-deadline clock_nanosleep pacing with jitter
//                        accounting (replaces time.sleep at
//                        train/bullet_mpc_differential_drive.py:101 and the
//                        realtime flags of the PyBullet loops).
//   2. telemetry ring  — lock-free single-producer/single-consumer ring buffer
//                        of fixed-size records, so the control thread never
//                        blocks on logging (replaces print()-based telemetry,
//                        SURVEY §5.5).
//   3. state channel   — seqlock-protected double buffer for robot-state /
//                        command exchange with a driver thread or process
//                        (the read→solve→actuate cycle of
//                        simulation/bullet_differential_drive_dnn.py:419-467).
//
// Plain C ABI; bound from Python with ctypes (no pybind11 in the image).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <new>

extern "C" {

// ---------------------------------------------------------------------------
// 1. Rate pacer
// ---------------------------------------------------------------------------

struct Pacer {
  int64_t period_ns;
  struct timespec next;
  int64_t ticks;
  int64_t overruns;
  int64_t worst_late_ns;
  int64_t total_late_ns;
};

static inline int64_t ts_to_ns(const struct timespec& t) {
  return static_cast<int64_t>(t.tv_sec) * 1000000000LL + t.tv_nsec;
}

static inline void ns_to_ts(int64_t ns, struct timespec* t) {
  t->tv_sec = ns / 1000000000LL;
  t->tv_nsec = ns % 1000000000LL;
}

Pacer* pacer_create(int64_t period_ns) {
  Pacer* p = new (std::nothrow) Pacer();
  if (!p) return nullptr;
  p->period_ns = period_ns;
  clock_gettime(CLOCK_MONOTONIC, &p->next);
  int64_t n = ts_to_ns(p->next) + period_ns;
  ns_to_ts(n, &p->next);
  p->ticks = 0;
  p->overruns = 0;
  p->worst_late_ns = 0;
  p->total_late_ns = 0;
  return p;
}

// Sleep until the next absolute deadline. Returns lateness in ns (>=0; 0 when
// the deadline was met). Deadlines advance by exactly one period per call so
// jitter does not accumulate. Retry ONLY on EINTR: any other nonzero return
// (e.g. EINVAL from a corrupt timespec) is permanent and retrying would spin
// forever at 100% CPU.
int64_t pacer_wait(Pacer* p) {
  int rc;
  while ((rc = clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &p->next,
                               nullptr)) == EINTR) {
  }
  (void)rc;  // non-EINTR failure: fall through and re-anchor below
  struct timespec now;
  clock_gettime(CLOCK_MONOTONIC, &now);
  int64_t late = ts_to_ns(now) - ts_to_ns(p->next);
  if (late < 0) late = 0;
  p->ticks++;
  p->total_late_ns += late;
  if (late > p->worst_late_ns) p->worst_late_ns = late;
  if (late > p->period_ns) {
    p->overruns++;
    // Re-anchor after a large overrun so we don't burst-catch-up.
    int64_t n = ts_to_ns(now) + p->period_ns;
    ns_to_ts(n, &p->next);
  } else {
    int64_t n = ts_to_ns(p->next) + p->period_ns;
    ns_to_ts(n, &p->next);
  }
  return late;
}

int64_t pacer_ticks(const Pacer* p) { return p->ticks; }
int64_t pacer_overruns(const Pacer* p) { return p->overruns; }
int64_t pacer_worst_late_ns(const Pacer* p) { return p->worst_late_ns; }
int64_t pacer_mean_late_ns(const Pacer* p) {
  return p->ticks ? p->total_late_ns / p->ticks : 0;
}
void pacer_destroy(Pacer* p) { delete p; }

// ---------------------------------------------------------------------------
// 2. Telemetry ring buffer (lock-free SPSC, fixed-size records)
// ---------------------------------------------------------------------------

struct Ring {
  uint8_t* data;
  int64_t capacity;     // number of records (power of two)
  int64_t record_size;  // bytes per record
  std::atomic<int64_t> head;  // next write index (producer)
  std::atomic<int64_t> tail;  // next read index (consumer)
  std::atomic<int64_t> dropped;
};

Ring* ring_create(int64_t capacity, int64_t record_size) {
  if (capacity <= 0 || (capacity & (capacity - 1)) != 0 || record_size <= 0)
    return nullptr;
  Ring* r = new (std::nothrow) Ring();
  if (!r) return nullptr;
  r->data = new (std::nothrow) uint8_t[capacity * record_size];
  if (!r->data) {
    delete r;
    return nullptr;
  }
  r->capacity = capacity;
  r->record_size = record_size;
  r->head.store(0, std::memory_order_relaxed);
  r->tail.store(0, std::memory_order_relaxed);
  r->dropped.store(0, std::memory_order_relaxed);
  return r;
}

// Producer: push one record. Returns 1 on success, 0 when full (record is
// counted as dropped — the control loop must never block).
int32_t ring_push(Ring* r, const void* record) {
  int64_t head = r->head.load(std::memory_order_relaxed);
  int64_t tail = r->tail.load(std::memory_order_acquire);
  if (head - tail >= r->capacity) {
    r->dropped.fetch_add(1, std::memory_order_relaxed);
    return 0;
  }
  std::memcpy(r->data + (head & (r->capacity - 1)) * r->record_size, record,
              r->record_size);
  r->head.store(head + 1, std::memory_order_release);
  return 1;
}

// Consumer: pop up to max_records into out. Returns number popped.
int64_t ring_pop(Ring* r, void* out, int64_t max_records) {
  int64_t tail = r->tail.load(std::memory_order_relaxed);
  int64_t head = r->head.load(std::memory_order_acquire);
  int64_t n = head - tail;
  if (n > max_records) n = max_records;
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(static_cast<uint8_t*>(out) + i * r->record_size,
                r->data + ((tail + i) & (r->capacity - 1)) * r->record_size,
                r->record_size);
  }
  r->tail.store(tail + n, std::memory_order_release);
  return n;
}

int64_t ring_dropped(const Ring* r) {
  return r->dropped.load(std::memory_order_relaxed);
}
void ring_destroy(Ring* r) {
  delete[] r->data;
  delete r;
}

// ---------------------------------------------------------------------------
// 3. Seqlock state channel (single writer, any readers; wait-free writer)
// ---------------------------------------------------------------------------

struct Channel {
  uint8_t* buf;
  int64_t size;
  std::atomic<uint64_t> seq;  // even = stable, odd = write in progress
};

Channel* chan_create(int64_t size) {
  Channel* c = new (std::nothrow) Channel();
  if (!c) return nullptr;
  c->buf = new (std::nothrow) uint8_t[size]();
  if (!c->buf) {
    delete c;
    return nullptr;
  }
  c->size = size;
  c->seq.store(0, std::memory_order_relaxed);
  return c;
}

// Seqlock buffer copies are intentionally concurrent (a reader may race a
// writer and then discard the torn snapshot via the seq check). A plain
// memcpy would make that race undefined behavior in the C++ memory model —
// and ThreadSanitizer rightly flags it — so the copies go through relaxed
// word-wise atomics (the Linux-kernel seqlock idiom): tearing is still
// possible, but each word access is well-defined and the seq protocol
// rejects torn reads. Exercised under TSAN by tests/test_runtime_stress.py.
static inline void seq_copy_in(uint8_t* dst, const uint8_t* src, int64_t n) {
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t w;
    std::memcpy(&w, src + i, 8);
    __atomic_store_n(reinterpret_cast<uint64_t*>(dst + i), w,
                     __ATOMIC_RELAXED);
  }
  for (; i < n; ++i) __atomic_store_n(dst + i, src[i], __ATOMIC_RELAXED);
}

static inline void seq_copy_out(uint8_t* dst, const uint8_t* src, int64_t n) {
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t w = __atomic_load_n(reinterpret_cast<const uint64_t*>(src + i),
                                 __ATOMIC_RELAXED);
    std::memcpy(dst + i, &w, 8);
  }
  for (; i < n; ++i) dst[i] = __atomic_load_n(src + i, __ATOMIC_RELAXED);
}

void chan_write(Channel* c, const void* data) {
  uint64_t s = c->seq.load(std::memory_order_relaxed);
  c->seq.store(s + 1, std::memory_order_release);  // mark dirty
  std::atomic_thread_fence(std::memory_order_release);
  seq_copy_in(c->buf, static_cast<const uint8_t*>(data), c->size);
  std::atomic_thread_fence(std::memory_order_release);
  c->seq.store(s + 2, std::memory_order_release);  // publish
}

// Returns the sequence number of the snapshot (even), or -1 if no write yet.
// Retries internally until a consistent snapshot is read.
int64_t chan_read(Channel* c, void* out) {
  for (;;) {
    uint64_t s1 = c->seq.load(std::memory_order_acquire);
    if (s1 == 0) return -1;
    if (s1 & 1) continue;  // write in progress
    std::atomic_thread_fence(std::memory_order_acquire);
    seq_copy_out(static_cast<uint8_t*>(out), c->buf, c->size);
    std::atomic_thread_fence(std::memory_order_acquire);
    uint64_t s2 = c->seq.load(std::memory_order_acquire);
    if (s1 == s2) return static_cast<int64_t>(s1);
  }
}

void chan_destroy(Channel* c) {
  delete[] c->buf;
  delete c;
}

}  // extern "C"
