// Native runtime support for DeepRecSys serving.
//
// Reference contrast: the reference's inter-process fabric is Python
// multiprocessing.Queue (pickle + pipe + locks) and its sub-5.5 ms pacing
// is a Python busy-wait holding the GIL (loadGenerator.py:57-64). Both are
// measurable serving overheads. This module provides:
//
//   1. A lock-free MPMC shared-memory ring queue for fixed-64-byte packets
//      (ServiceRequest/ServiceResponse are plain ints/floats/bools, so
//      they map onto POD slots with no serialization at all).
//      Design: classic Vyukov bounded MPMC queue — per-slot sequence
//      numbers; producers/consumers claim slots with a CAS on head/tail.
//      Works intra-process (threads) and across fork'd processes when the
//      buffer lives in a shared mmap.
//
//   2. precise_sleep_ns: clock_nanosleep for the bulk + short spin tail,
//      called through ctypes (which drops the GIL) so pacing no longer
//      starves engine threads.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 (see runtime/native.py).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kMagic = 0x44525351554555ULL;  // "DRSQUEU"

struct Slot {
  std::atomic<uint64_t> seq;
  unsigned char payload[64];
};

struct RingHeader {
  uint64_t magic;
  uint64_t capacity;       // power of two
  uint64_t mask;
  alignas(64) std::atomic<uint64_t> head;  // next enqueue ticket
  alignas(64) std::atomic<uint64_t> tail;  // next dequeue ticket
  alignas(64) Slot slots[];                // capacity slots
};

}  // namespace

extern "C" {

// Bytes needed for a ring of `capacity` (must be power of two) slots.
uint64_t drs_ring_bytes(uint64_t capacity) {
  return sizeof(RingHeader) + capacity * sizeof(Slot);
}

// Initialize a ring in caller-provided (shared) memory.
int drs_ring_init(void* mem, uint64_t capacity) {
  if (capacity == 0 || (capacity & (capacity - 1)) != 0) return -1;
  auto* h = new (mem) RingHeader();
  h->magic = kMagic;
  h->capacity = capacity;
  h->mask = capacity - 1;
  h->head.store(0, std::memory_order_relaxed);
  h->tail.store(0, std::memory_order_relaxed);
  for (uint64_t i = 0; i < capacity; ++i) {
    h->slots[i].seq.store(i, std::memory_order_relaxed);
  }
  std::atomic_thread_fence(std::memory_order_seq_cst);
  return 0;
}

// Non-blocking enqueue of one 64-byte payload. 0 on success, -1 if full.
int drs_ring_push(void* mem, const void* payload) {
  auto* h = static_cast<RingHeader*>(mem);
  uint64_t pos = h->head.load(std::memory_order_relaxed);
  for (;;) {
    Slot& s = h->slots[pos & h->mask];
    uint64_t seq = s.seq.load(std::memory_order_acquire);
    intptr_t dif = (intptr_t)seq - (intptr_t)pos;
    if (dif == 0) {
      if (h->head.compare_exchange_weak(pos, pos + 1, std::memory_order_relaxed)) {
        std::memcpy(s.payload, payload, 64);
        s.seq.store(pos + 1, std::memory_order_release);
        return 0;
      }
    } else if (dif < 0) {
      return -1;  // full
    } else {
      pos = h->head.load(std::memory_order_relaxed);
    }
  }
}

// Non-blocking dequeue. 0 on success, -1 if empty.
int drs_ring_pop(void* mem, void* payload_out) {
  auto* h = static_cast<RingHeader*>(mem);
  uint64_t pos = h->tail.load(std::memory_order_relaxed);
  for (;;) {
    Slot& s = h->slots[pos & h->mask];
    uint64_t seq = s.seq.load(std::memory_order_acquire);
    intptr_t dif = (intptr_t)seq - (intptr_t)(pos + 1);
    if (dif == 0) {
      if (h->tail.compare_exchange_weak(pos, pos + 1, std::memory_order_relaxed)) {
        std::memcpy(payload_out, s.payload, 64);
        s.seq.store(pos + h->capacity, std::memory_order_release);
        return 0;
      }
    } else if (dif < 0) {
      return -1;  // empty
    } else {
      pos = h->tail.load(std::memory_order_relaxed);
    }
  }
}

// Blocking pop with timeout (ns). Spin + sched_yield escalation.
// Returns 0 on success, -1 on timeout.
int drs_ring_pop_wait(void* mem, void* payload_out, int64_t timeout_ns) {
  struct timespec start, now;
  clock_gettime(CLOCK_MONOTONIC, &start);
  int spins = 0;
  for (;;) {
    if (drs_ring_pop(mem, payload_out) == 0) return 0;
    if (++spins > 64) {
      struct timespec ts = {0, 50000};  // 50 us
      nanosleep(&ts, nullptr);
    }
    clock_gettime(CLOCK_MONOTONIC, &now);
    int64_t elapsed = (int64_t)(now.tv_sec - start.tv_sec) * 1000000000LL +
                      (now.tv_nsec - start.tv_nsec);
    if (timeout_ns >= 0 && elapsed > timeout_ns) return -1;
  }
}

uint64_t drs_ring_approx_size(void* mem) {
  auto* h = static_cast<RingHeader*>(mem);
  uint64_t head = h->head.load(std::memory_order_relaxed);
  uint64_t tail = h->tail.load(std::memory_order_relaxed);
  return head >= tail ? head - tail : 0;
}

// Precise sleep: clock_nanosleep for all but the last `spin_ns`, then spin.
// Called via ctypes => GIL is released for the whole duration.
void drs_precise_sleep_ns(int64_t total_ns, int64_t spin_ns) {
  struct timespec start, now;
  clock_gettime(CLOCK_MONOTONIC, &start);
  int64_t coarse = total_ns - spin_ns;
  if (coarse > 0) {
    struct timespec ts = {(time_t)(coarse / 1000000000LL), (long)(coarse % 1000000000LL)};
    nanosleep(&ts, nullptr);
  }
  for (;;) {
    clock_gettime(CLOCK_MONOTONIC, &now);
    int64_t elapsed = (int64_t)(now.tv_sec - start.tv_sec) * 1000000000LL +
                      (now.tv_nsec - start.tv_nsec);
    if (elapsed >= total_ns) return;
  }
}

// Hot/cold lookup splitter (native path of ops/embedding.py
// split_hot_cold). One parallel pass instead of numpy's six array passes:
// per lookup, compose the fused id (table-local id + table offset), binary
// search the sorted hot set, and either record the hot position or append
// the fused id + pooling-group id to the compacted cold stream. This runs
// on the serving host critical path (once per batch), so it must cost less
// than the HBM gather time it saves on-chip.
//
// Layout: indices is the flattened (B, T, L) array, so lookup i belongs to
// table (i / L) % T and pooling group i / L.
//
// Parallel compaction: each thread scans a contiguous chunk and writes its
// cold entries at the chunk's own base offset in the output buffers (a
// chunk can never produce more cold entries than its length), then the
// chunks are memmove'd tight after a prefix-sum over per-chunk counts —
// preserving the ascending order the numpy path produces.
//
// Returns the cold count; caller pads to its bucket ladder.
namespace {

// Persistent worker pool for the splitter. It runs once per served
// request on the host critical path, and fresh std::thread create/join
// (~20-60 us each) rivals the scan itself at serving batch sizes.
// Design: a shared task queue of (job, chunk) pairs; each job carries its
// own completion counter + condvar behind a shared_ptr, so stragglers
// from one request can never consume another request's chunk indices
// (concurrent engine threads may overlap calls). The singleton leaks
// deliberately: detached workers may still be parked on the queue
// condvar at process exit, and destroying it under them is UB.
class SplitPool {
 public:
  static SplitPool& get() {
    static SplitPool* p = new SplitPool();
    return *p;
  }

  void run(int n_chunks, std::function<void(int)> fn) {
    if (n_chunks <= 1) {
      if (n_chunks == 1) fn(0);
      return;
    }
    auto job = std::make_shared<Job>();
    job->fn = std::move(fn);
    job->remaining.store(n_chunks, std::memory_order_relaxed);
    ensure_workers(std::min(n_chunks - 1, max_helpers()));
    {
      std::lock_guard<std::mutex> lk(qm_);
      for (int c = 1; c < n_chunks; ++c) tasks_.push_back(Task{job, c});
    }
    qcv_.notify_all();
    exec(job, 0);  // the caller works chunk 0 itself...
    for (;;) {     // ...then helps drain until its own job completes
      Task t;
      {
        std::lock_guard<std::mutex> lk(qm_);
        if (job->remaining.load(std::memory_order_acquire) == 0 ||
            tasks_.empty())
          break;
        t = std::move(tasks_.front());
        tasks_.pop_front();
      }
      exec(t.job, t.c);
    }
    std::unique_lock<std::mutex> lk(job->m);
    job->cv.wait(lk, [&] {
      return job->remaining.load(std::memory_order_acquire) == 0;
    });
  }

 private:
  struct Job {
    std::function<void(int)> fn;
    std::atomic<int> remaining{0};
    std::mutex m;
    std::condition_variable cv;
  };
  struct Task {
    std::shared_ptr<Job> job;
    int c = 0;
  };

  static int max_helpers() {
    return (int)std::min<unsigned>(
               std::max(1u, std::thread::hardware_concurrency()), 8) -
           1;
  }

  static void exec(const std::shared_ptr<Job>& j, int c) {
    j->fn(c);
    if (j->remaining.fetch_sub(1, std::memory_order_acq_rel) == 1) {
      std::lock_guard<std::mutex> lk(j->m);
      j->cv.notify_all();
    }
  }

  void worker_loop() {
    for (;;) {
      Task t;
      {
        std::unique_lock<std::mutex> lk(qm_);
        qcv_.wait(lk, [&] { return !tasks_.empty(); });
        t = std::move(tasks_.front());
        tasks_.pop_front();
      }
      exec(t.job, t.c);
    }
  }

  void ensure_workers(int want) {
    std::lock_guard<std::mutex> lk(qm_);
    while (n_workers_ < want) {
      std::thread([this] { worker_loop(); }).detach();
      ++n_workers_;
    }
  }

  std::mutex qm_;
  std::condition_variable qcv_;
  std::deque<Task> tasks_;
  int n_workers_ = 0;
};

}  // namespace

// Persistent hot-set hash index. The per-lookup membership probe is the
// splitter's dominant cost: lower_bound over a K-entry sorted array costs
// ~log2(K) dependent cache misses per lookup (K~1e6 => ~20 misses into a
// multi-MB array). An open-addressing table sized 2K brings that to ~1
// miss. The table is built ONCE per hot-set install (engine setup or a
// refresh swap — both off the dispatch critical path) and probed by every
// subsequent split; entries pack (key, sorted-position) in 16 bytes so a
// probe usually touches one cache line.
struct HotIndexEntry {
  int64_t key;  // fused row id; -1 = empty (fused ids are >= 0)
  int64_t val;  // position in the SORTED hot_ids array (the hot_sel value)
};

struct HotIndexImpl {
  uint64_t mask = 0;                   // table size - 1 (power of two)
  std::vector<HotIndexEntry> entries;  // mask + 1 slots
};

namespace {
// splitmix64 finalizer: full-avalanche 64-bit mix.
inline uint64_t drs_mix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}
}  // namespace

extern "C" void* drs_hot_index_build(const int64_t* hot_ids, int64_t K) {
  if (K <= 0) return nullptr;  // empty set: callers fall back (all-cold)
  uint64_t size = 16;
  while (size < (uint64_t)K * 2) size <<= 1;  // load factor <= 0.5
  auto* idx = new HotIndexImpl();
  idx->mask = size - 1;
  idx->entries.assign(size, HotIndexEntry{-1, 0});
  for (int64_t i = 0; i < K; ++i) {
    uint64_t h = drs_mix64((uint64_t)hot_ids[i]) & idx->mask;
    while (idx->entries[h].key != -1) h = (h + 1) & idx->mask;
    idx->entries[h].key = hot_ids[i];
    idx->entries[h].val = i;
  }
  return idx;
}

extern "C" void drs_hot_index_free(void* p) {
  delete static_cast<HotIndexImpl*>(p);
}

// `slot_mask` (nullable, n bytes): ragged pooling — a 0 slot is a padded
// (invalid) lookup that must contribute NOTHING: neither a hot hit nor a
// cold lookup (exact variable-length SparseLengthsSum semantics,
// reference dlrm_s_caffe2.py:179-211 lengths queues).
// `hot_index` (nullable): prebuilt drs_hot_index_build table over the SAME
// hot_ids array; when present the membership probe is O(1) expected
// instead of the binary search. Outputs are bit-identical either way.
extern "C" int64_t drs_split_hot_cold_indexed(
    const int32_t* indices, int64_t n, const int64_t* offsets, int64_t T,
    int64_t L, const int64_t* hot_ids, int64_t K, const uint8_t* slot_mask,
    const void* hot_index, int32_t* hot_sel, uint8_t* hot_mask,
    int32_t* cold_ids, int32_t* cold_seg, int32_t n_threads) {
  if (n == 0) return 0;
  int nt = n_threads > 0 ? n_threads
                         : (int)std::min<int64_t>(
                               std::max(1u, std::thread::hardware_concurrency()), 8);
  // Align chunk boundaries to L so group ids stay trivially computable and
  // cold order within a group is contiguous.
  int64_t groups = n / L;
  int64_t groups_per_chunk = (groups + nt - 1) / nt;
  if (groups_per_chunk == 0) groups_per_chunk = 1;
  int n_chunks = (int)((groups + groups_per_chunk - 1) / groups_per_chunk);
  std::vector<int64_t> chunk_cold(n_chunks, 0);
  const auto* hidx = static_cast<const HotIndexImpl*>(hot_index);

  // Indexed path: two-pass blocks. Pass 1 computes fused ids + hash slots
  // for a block and issues software prefetches; pass 2 probes — by then
  // most entry lines have arrived, so probes overlap instead of paying one
  // serialized DRAM miss each. Group/table ids advance by counters (no
  // per-lookup div/mod). The binary-search fallback keeps the simple loop.
  auto work = [&](int c) {
    int64_t g_lo = (int64_t)c * groups_per_chunk;
    int64_t g_hi = std::min(groups, g_lo + groups_per_chunk);
    int64_t lo = g_lo * L, hi = g_hi * L;
    int64_t w = lo;  // chunk-local cold write cursor (base = chunk start)
    if (hidx) {
      constexpr int kBlk = 256;
      constexpr uint64_t kInvalid = ~0ULL;  // > any table mask
      int64_t fused_blk[kBlk];
      uint64_t hash_blk[kBlk];
      int32_t seg_blk[kBlk];
      int64_t g = g_lo, r = 0, t = g_lo % T;
      for (int64_t i = lo; i < hi;) {
        int blk = (int)std::min<int64_t>(kBlk, hi - i);
        for (int k = 0; k < blk; ++k) {
          int64_t ii = i + k;
          if (slot_mask && !slot_mask[ii]) {
            hash_blk[k] = kInvalid;
          } else {
            int64_t fused = (int64_t)indices[ii] + offsets[t];
            uint64_t h = drs_mix64((uint64_t)fused) & hidx->mask;
            fused_blk[k] = fused;
            hash_blk[k] = h;
            seg_blk[k] = (int32_t)g;
            __builtin_prefetch(&hidx->entries[h], 0, 1);
          }
          if (++r == L) {
            r = 0;
            ++g;
            if (++t == T) t = 0;
          }
        }
        for (int k = 0; k < blk; ++k) {
          int64_t ii = i + k;
          if (hash_blk[k] == kInvalid) {
            hot_sel[ii] = 0;
            hot_mask[ii] = 0;  // zero via the hot-side mask-pool,
            continue;          // never enters the cold stream
          }
          uint64_t h = hash_blk[k];
          int64_t fused = fused_blk[k];
          int64_t pos = -1;
          for (;;) {
            const HotIndexEntry& e = hidx->entries[h];
            if (e.key == fused) {
              pos = e.val;
              break;
            }
            if (e.key == -1) break;
            h = (h + 1) & hidx->mask;
          }
          if (pos >= 0) {
            hot_sel[ii] = (int32_t)pos;
            hot_mask[ii] = 1;
          } else {
            hot_sel[ii] = 0;
            hot_mask[ii] = 0;
            cold_ids[w] = (int32_t)fused;
            cold_seg[w] = seg_blk[k];
            ++w;
          }
        }
        i += blk;
      }
    } else {
      for (int64_t i = lo; i < hi; ++i) {
        if (slot_mask && !slot_mask[i]) {
          hot_sel[i] = 0;
          hot_mask[i] = 0;  // contributes zero via the hot-side mask-pool
          continue;         // and never enters the cold stream
        }
        int64_t g = i / L;
        int64_t t = g % T;
        int64_t fused = (int64_t)indices[i] + offsets[t];
        int64_t pos = -1;
        const int64_t* p = std::lower_bound(hot_ids, hot_ids + K, fused);
        if (p != hot_ids + K && *p == fused) pos = p - hot_ids;
        if (pos >= 0) {
          hot_sel[i] = (int32_t)pos;
          hot_mask[i] = 1;
        } else {
          hot_sel[i] = 0;
          hot_mask[i] = 0;
          cold_ids[w] = (int32_t)fused;
          cold_seg[w] = (int32_t)g;
          ++w;
        }
      }
    }
    chunk_cold[c] = w - lo;
  };

  // Persistent pool (no per-request thread create/join on the hot path).
  SplitPool::get().run(n_chunks, work);

  // Compact: move each chunk's cold run down to the running total.
  int64_t total = chunk_cold[0];
  for (int c = 1; c < n_chunks; ++c) {
    int64_t src = (int64_t)c * groups_per_chunk * L;
    if (chunk_cold[c] > 0 && src != total) {
      std::memmove(cold_ids + total, cold_ids + src,
                   chunk_cold[c] * sizeof(int32_t));
      std::memmove(cold_seg + total, cold_seg + src,
                   chunk_cold[c] * sizeof(int32_t));
    }
    total += chunk_cold[c];
  }
  return total;
}

extern "C" int64_t drs_split_hot_cold_masked(
    const int32_t* indices, int64_t n, const int64_t* offsets, int64_t T,
    int64_t L, const int64_t* hot_ids, int64_t K, const uint8_t* slot_mask,
    int32_t* hot_sel, uint8_t* hot_mask, int32_t* cold_ids,
    int32_t* cold_seg, int32_t n_threads) {
  return drs_split_hot_cold_indexed(indices, n, offsets, T, L, hot_ids, K,
                                    slot_mask, nullptr, hot_sel, hot_mask,
                                    cold_ids, cold_seg, n_threads);
}

extern "C" int64_t drs_split_hot_cold(
    const int32_t* indices, int64_t n, const int64_t* offsets, int64_t T,
    int64_t L, const int64_t* hot_ids, int64_t K, int32_t* hot_sel,
    uint8_t* hot_mask, int32_t* cold_ids, int32_t* cold_seg,
    int32_t n_threads) {
  return drs_split_hot_cold_indexed(indices, n, offsets, T, L, hot_ids, K,
                                    nullptr, nullptr, hot_sel, hot_mask,
                                    cold_ids, cold_seg, n_threads);
}

// LRU stack-distance trace generator (native path of
// data/trace.py trace_generate_lru + generate_stack_distance): draw a
// stack distance from the measured CDF; sd==0 introduces the next unseen
// line (head of the rotation), sd>0 re-references the line at LRU depth
// sd and moves it to the top. This is the data-loader hot loop when
// generating locality-modeled synthetic streams.
//
// `lines` is the logical LRU list stored as a ring with head offset *h_io
// (pop(0)+append == advance head, value stays in place — the dominant
// sd==0 case is O(1)). Deterministic via a caller-held splitmix64 state.
// Returns the updated introduced-lines counter i.
namespace {

inline double drs_rand_u01(uint64_t* s) {
  uint64_t z = (*s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  z ^= z >> 31;
  return (double)(z >> 11) * (1.0 / 9007199254740992.0);  // 53-bit
}

}  // namespace

extern "C" int64_t drs_trace_generate_lru(
    int64_t* lines, int64_t n, int64_t* h_io, const int64_t* sd_vals,
    const double* sd_cdf, int64_t n_sd, int64_t out_len, int64_t* out,
    uint64_t* rng_state, int enable_padding, int64_t i_in) {
  int64_t h = *h_io;
  int64_t i = i_in;
  int64_t max_i = sd_vals[n_sd - 1];
  for (int64_t k = 0; k < out_len; ++k) {
    // generate_stack_distance (trace.py:72-89)
    double u = drs_rand_u01(rng_state);
    if (i < max_i) {
      // bisect.bisect(cumm_val, i) - 1
      const int64_t* p = std::upper_bound(sd_vals, sd_vals + n_sd, i);
      int64_t j = (p - sd_vals) - 1;
      if (j >= 0) u *= sd_cdf[j];
    } else if (enable_padding) {
      double fi = sd_cdf[0];
      u = (1.0 - fi) * u + fi;
    }
    const double* q = std::lower_bound(sd_cdf, sd_cdf + n_sd, u);
    int64_t j = q - sd_cdf;
    if (j >= n_sd) j = n_sd - 1;
    int64_t sd = sd_vals[j];

    int64_t ref;
    if (sd == 0) {
      // pop(0) + append: head value stays physically in place.
      ref = lines[h];
      h = (h + 1) % n;
      ++i;
    } else {
      int64_t pos = n - sd;
      if (pos < 0) pos = 0;
      if (pos > n - 1) pos = n - 1;
      // Shift logical [pos+1, n) left one slot, then place ref at the
      // logical end. Physically that is at most two contiguous memmoves
      // (the ring wraps once at slot n-1 -> 0).
      int64_t start = (h + pos) % n;
      int64_t end = (h + n - 1) % n;
      ref = lines[start];
      if (start <= end) {
        std::memmove(lines + start, lines + start + 1,
                     (size_t)(end - start) * sizeof(int64_t));
      } else {
        std::memmove(lines + start, lines + start + 1,
                     (size_t)(n - 1 - start) * sizeof(int64_t));
        lines[n - 1] = lines[0];
        std::memmove(lines, lines + 1, (size_t)end * sizeof(int64_t));
      }
      lines[end] = ref;
    }
    out[k] = ref;
  }
  *h_io = h;
  return i;
}

}  // extern "C"
