// Concurrency stress harness for the dmmrt lock-free structures (SURVEY §5.2:
// the reference has no sanitizers; this is the race-detection subsystem the
// new framework adds). Run standalone (-O2) for throughput-level stress and
// under -fsanitize=thread for data-race detection — both driven by
// tests/test_torch_runtime.py (vendored from dnn_mppi_mpc_tpu/runtime/src).
//
// Checks are semantic, not just crash-freedom:
//   ring:    every record produced is consumed exactly once, in FIFO order,
//            with an intact payload (sequence number replicated + checksum);
//            drops are only ever reported by the producer, never silent.
//   seqlock: readers must never observe a torn snapshot — the writer always
//            publishes a buffer whose words all equal the same counter, so
//            any mixed-valued snapshot is a consistency violation.
//   pacer:   deadlines advance monotonically and lateness accounting is sane.
//
// Exit code 0 = all invariants held; 1 = violation (message on stderr).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

// C ABI under test (dmmrt.cpp is compiled into the same binary).
extern "C" {
struct Ring;
struct Channel;
struct Pacer;
Ring* ring_create(int64_t capacity, int64_t record_size);
int32_t ring_push(Ring* r, const void* record);
int64_t ring_pop(Ring* r, void* out, int64_t max_records);
int64_t ring_dropped(const Ring* r);
void ring_destroy(Ring* r);
Channel* chan_create(int64_t size);
void chan_write(Channel* c, const void* data);
int64_t chan_read(Channel* c, void* out);
void chan_destroy(Channel* c);
Pacer* pacer_create(int64_t period_ns);
int64_t pacer_wait(Pacer* p);
int64_t pacer_ticks(const Pacer* p);
int64_t pacer_overruns(const Pacer* p);
int64_t pacer_worst_late_ns(const Pacer* p);
void pacer_destroy(Pacer* p);
}

static std::atomic<int> g_failures{0};

static void fail(const char* what) {
  std::fprintf(stderr, "STRESS VIOLATION: %s\n", what);
  g_failures.fetch_add(1, std::memory_order_relaxed);
}

// --------------------------------------------------------------------------
// SPSC telemetry ring: 1 producer, 1 consumer, tiny capacity to force
// wrap-around and full-ring backpressure constantly.
// --------------------------------------------------------------------------
struct Record {
  uint64_t seq;
  uint64_t payload[6];  // filled with seq * k — checksummed on pop
};

static void stress_ring(int64_t n_records) {
  Ring* r = ring_create(/*capacity=*/16, sizeof(Record));
  if (!r) return fail("ring_create failed");
  std::atomic<uint64_t> produced_ok{0};

  std::thread producer([&] {
    Record rec;
    for (uint64_t s = 0; s < static_cast<uint64_t>(n_records); ++s) {
      rec.seq = s;
      for (int k = 0; k < 6; ++k) rec.payload[k] = s * (k + 1);
      while (!ring_push(r, &rec)) {
      }  // spin on full: every record must arrive exactly once
      produced_ok.fetch_add(1, std::memory_order_relaxed);
    }
  });

  std::thread consumer([&] {
    Record out[8];
    uint64_t expect = 0;
    while (expect < static_cast<uint64_t>(n_records)) {
      int64_t n = ring_pop(r, out, 8);
      for (int64_t i = 0; i < n; ++i) {
        if (out[i].seq != expect) {
          fail("ring FIFO order broken");
          expect = out[i].seq;  // resync so we still terminate
        }
        for (int k = 0; k < 6; ++k)
          if (out[i].payload[k] != out[i].seq * (k + 1)) {
            fail("ring payload corrupted");
            break;
          }
        ++expect;
      }
    }
  });

  producer.join();
  consumer.join();
  ring_destroy(r);
}

// Drop accounting (single-threaded): a full ring must reject pushes and
// count each rejection exactly once; draining must restore capacity.
static void check_ring_drops() {
  Ring* r = ring_create(8, sizeof(Record));
  if (!r) return fail("ring_create failed");
  Record rec{};
  for (int i = 0; i < 8; ++i)
    if (!ring_push(r, &rec)) fail("push rejected below capacity");
  for (int i = 0; i < 5; ++i)
    if (ring_push(r, &rec)) fail("push accepted beyond capacity");
  if (ring_dropped(r) != 5) fail("drop count wrong");
  Record out[8];
  if (ring_pop(r, out, 8) != 8) fail("drain count wrong");
  if (!ring_push(r, &rec)) fail("push rejected after drain");
  ring_destroy(r);
}

// --------------------------------------------------------------------------
// Seqlock channel: 1 writer spinning counters, R readers verifying snapshot
// atomicity (all words of a snapshot must carry the same counter value, and
// counters must be monotone per reader — the writer only moves forward).
// --------------------------------------------------------------------------
static void stress_seqlock(int n_readers, int64_t n_writes) {
  constexpr int kWords = 9;  // odd size in words; +3 tail bytes below
  constexpr int64_t kBytes = kWords * 8 + 3;
  Channel* c = chan_create(kBytes);
  if (!c) return fail("chan_create failed");
  std::atomic<bool> done{false};

  std::thread writer([&] {
    uint8_t buf[kBytes];
    for (uint64_t v = 1; v <= static_cast<uint64_t>(n_writes); ++v) {
      uint64_t w[kWords];
      for (int k = 0; k < kWords; ++k) w[k] = v;
      std::memcpy(buf, w, kWords * 8);
      buf[kBytes - 3] = buf[kBytes - 2] = buf[kBytes - 1] =
          static_cast<uint8_t>(v & 0xff);
      chan_write(c, buf);
    }
    done.store(true, std::memory_order_release);
  });

  std::vector<std::thread> readers;
  for (int t = 0; t < n_readers; ++t) {
    readers.emplace_back([&] {
      uint8_t buf[kBytes];
      uint64_t last_v = 0;
      int64_t last_seq = -1;
      while (!done.load(std::memory_order_acquire)) {
        int64_t seq = chan_read(c, buf);
        if (seq < 0) continue;  // nothing published yet
        uint64_t w[kWords];
        std::memcpy(w, buf, kWords * 8);
        for (int k = 1; k < kWords; ++k)
          if (w[k] != w[0]) {
            fail("seqlock torn snapshot (mixed words)");
            break;
          }
        if (buf[kBytes - 1] != static_cast<uint8_t>(w[0] & 0xff))
          fail("seqlock torn snapshot (tail bytes)");
        if (w[0] < last_v) fail("seqlock snapshot went backwards");
        if (seq < last_seq) fail("seqlock sequence went backwards");
        last_v = w[0];
        last_seq = seq;
      }
    });
  }

  writer.join();
  for (auto& t : readers) t.join();
  chan_destroy(c);
}

// --------------------------------------------------------------------------
// Pacer: short real-time smoke (single-threaded; checks accounting sanity).
// --------------------------------------------------------------------------
static void stress_pacer() {
  Pacer* p = pacer_create(2'000'000);  // 2 ms
  if (!p) return fail("pacer_create failed");
  for (int i = 0; i < 25; ++i) {
    int64_t late = pacer_wait(p);
    if (late < 0) fail("pacer negative lateness");
  }
  if (pacer_ticks(p) != 25) fail("pacer tick count wrong");
  if (pacer_worst_late_ns(p) < 0) fail("pacer worst lateness negative");
  if (pacer_overruns(p) > 25) fail("pacer overrun count impossible");
  pacer_destroy(p);
}

int main(int argc, char** argv) {
  // Scale knobs so the TSAN build (10-20x slower) can run shorter.
  int64_t ring_records = argc > 1 ? std::atoll(argv[1]) : 2000000;
  int64_t seq_writes = argc > 2 ? std::atoll(argv[2]) : 1000000;
  int rounds = argc > 3 ? std::atoi(argv[3]) : 3;

  for (int i = 0; i < rounds; ++i) {
    stress_ring(ring_records);
    stress_seqlock(/*n_readers=*/3, seq_writes);
  }
  check_ring_drops();
  stress_pacer();

  int f = g_failures.load(std::memory_order_relaxed);
  if (f) {
    std::fprintf(stderr, "FAILED: %d violations\n", f);
    return 1;
  }
  std::printf("OK\n");
  return 0;
}
