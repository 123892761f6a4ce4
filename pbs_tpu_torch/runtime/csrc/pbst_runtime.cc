// pbst_runtime: native hot-path primitives for PBS-T.
//
// The reference keeps its hot paths in C inside the hypervisor: the
// seqlock counter-state pages read by guests with zero
// syscalls/hypercalls (linux-3.2.30/drivers/perfctr/x86.c:228-312) and
// the lockless per-CPU trace rings drained by dom0
// (xen-4.2.1/xen/common/trace.c). This library provides the same two
// primitives over caller-provided shared memory so multi-process
// monitors read telemetry without locks or RPCs. Byte-compatible with
// the pure-Python implementations (pbs_tpu_torch/telemetry/ledger.py,
// pbs_tpu_torch/obs/trace.py), which remain as fallbacks.
//
// The port's copy of the JAX package's runtime: the C ABI, the byte
// layouts and the arithmetic are the reference's, word for word; only
// comments differ.
//
// Build: pbs_tpu_torch/runtime/native.py at first use (g++ -O2
//        -std=c++17 -fPIC -shared, no dependencies), into
//        pbs_tpu_torch/build/ under a digest of sources and flags.
// Bind:  ctypes (pbs_tpu_torch/runtime/native.py). No pybind11 by
// design — the ABI is a handful of flat functions over uint64 buffers.

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// Seqlock ledger.
//
// Slot layout (u64 words): [0] version  [1] tsc_start
//                          [2..19] sums[18]  [20..37] start[18]
// ---------------------------------------------------------------------------

static const int kNumCounters = 18;
static const int kHeaderWords = 2;
static const int kSlotWords = kHeaderWords + 2 * kNumCounters;  // 38

static inline uint64_t* slot_ptr(uint64_t* buf, int64_t slot) {
  return buf + slot * kSlotWords;
}

static inline void write_begin(uint64_t* s) {
  uint64_t v = __atomic_load_n(&s[0], __ATOMIC_RELAXED);
  __atomic_store_n(&s[0], v + 1, __ATOMIC_RELEASE);  // odd: writing
  __atomic_thread_fence(__ATOMIC_RELEASE);
}

static inline void write_end(uint64_t* s) {
  __atomic_thread_fence(__ATOMIC_RELEASE);
  uint64_t v = __atomic_load_n(&s[0], __ATOMIC_RELAXED);
  __atomic_store_n(&s[0], v + 1, __ATOMIC_RELEASE);  // even: stable
}

int pbst_ledger_slot_words() { return kSlotWords; }

void pbst_ledger_reset(uint64_t* buf, int64_t slot) {
  uint64_t* s = slot_ptr(buf, slot);
  write_begin(s);
  std::memset(&s[1], 0, (kSlotWords - 1) * sizeof(uint64_t));
  write_end(s);
}

// Mark running (pmu_restore_regs analog). now_ns==0 is promoted to 1:
// tsc_start doubles as the running flag.
void pbst_ledger_resume(uint64_t* buf, int64_t slot, uint64_t now_ns,
                        const uint64_t* live_or_null) {
  uint64_t* s = slot_ptr(buf, slot);
  write_begin(s);
  if (live_or_null != nullptr) {
    std::memcpy(&s[kHeaderWords + kNumCounters], live_or_null,
                kNumCounters * sizeof(uint64_t));
  }
  s[1] = now_ns ? now_ns : 1;
  write_end(s);
}

// Fold deltas into sums, mark suspended (pmu_save_regs /
// perfctr_cpu_vsuspend analog).
void pbst_ledger_suspend(uint64_t* buf, int64_t slot,
                         const uint64_t* deltas) {
  uint64_t* s = slot_ptr(buf, slot);
  write_begin(s);
  for (int i = 0; i < kNumCounters; i++) s[kHeaderWords + i] += deltas[i];
  s[1] = 0;
  write_end(s);
}

void pbst_ledger_add(uint64_t* buf, int64_t slot, int counter,
                     uint64_t delta) {
  uint64_t* s = slot_ptr(buf, slot);
  write_begin(s);
  s[kHeaderWords + counter] += delta;
  write_end(s);
}

void pbst_ledger_add_many(uint64_t* buf, int64_t slot,
                          const uint64_t* deltas) {
  uint64_t* s = slot_ptr(buf, slot);
  write_begin(s);
  for (int i = 0; i < kNumCounters; i++) s[kHeaderWords + i] += deltas[i];
  write_end(s);
}

// Lock-free consistent snapshot of sums[]. Returns the number of
// retries used, or -1 if max_retries were exhausted. The retry
// contract of drivers/perfctr/x86.c:228-312.
int pbst_ledger_snapshot(const uint64_t* buf, int64_t slot, uint64_t* out,
                         int max_retries) {
  const uint64_t* s = buf + slot * kSlotWords;
  for (int attempt = 0; attempt < max_retries; attempt++) {
    uint64_t v0 = __atomic_load_n(&s[0], __ATOMIC_ACQUIRE);
    if (v0 & 1) continue;
    __atomic_thread_fence(__ATOMIC_ACQUIRE);
    uint64_t tmp[kNumCounters];
    std::memcpy(tmp, &s[kHeaderWords], sizeof(tmp));
    __atomic_thread_fence(__ATOMIC_ACQUIRE);
    uint64_t v1 = __atomic_load_n(&s[0], __ATOMIC_ACQUIRE);
    if (v0 == v1) {
      std::memcpy(out, tmp, sizeof(tmp));
      return attempt;
    }
  }
  return -1;
}

uint64_t pbst_ledger_tsc_start(const uint64_t* buf, int64_t slot) {
  return __atomic_load_n(&(buf + slot * kSlotWords)[1], __ATOMIC_ACQUIRE);
}

// Vectorized snapshot: the whole slot VECTOR in one C call, with the
// retry loop PER SLOT (the scalar pbst_ledger_snapshot contract) —
// each row is individually seqlock-consistent, and a busy writer on
// one slot cannot burn the other slots' retry budget (an all-slots
// round would multiply the tear exposure by the vector length; rows
// of a counter snapshot don't need mutual consistency). out is
// (n_slots, 18) row-major. Returns the WORST per-slot retry count,
// -1 if any slot exhausted max_retries, or -2 if any slot falls
// outside [0, total_slots) — bounds live here because a numpy
// min/max pre-check costs more than the whole call.
int pbst_ledger_snapshot_many(const uint64_t* buf, int64_t total_slots,
                              const int64_t* slots, int n_slots,
                              uint64_t* out, int max_retries) {
  for (int i = 0; i < n_slots; i++) {
    if (slots[i] < 0 || slots[i] >= total_slots) return -2;
  }
  int worst = 0;
  for (int i = 0; i < n_slots; i++) {
    int rc = pbst_ledger_snapshot(buf, slots[i],
                                  out + (int64_t)i * kNumCounters,
                                  max_retries);
    if (rc < 0) return -1;
    if (rc > worst) worst = rc;
  }
  return worst;
}

// ---------------------------------------------------------------------------
// Log2 latency histograms in ledger slots (pbs_tpu_torch/obs/spans.py).
//
// The slot IS the histogram: the 18 counter words are the buckets.
// Bucket b = clamp(bit_length(value) - 1 - shift, 0, 17) — identical
// to the Python hist_bucket (HIST_SHIFT=13 upstack). The seqlock
// protocol is the per-record write_begin/write_end of pbst_ledger_add,
// so N batched records leave byte-identical slot state (version word
// included) to N scalar calls in either language.
// ---------------------------------------------------------------------------

static inline int hist_bucket_of(uint64_t value, int shift) {
  int bl = value ? 64 - __builtin_clzll(value) : 0;  // bit_length
  int b = bl - 1 - shift;
  if (b < 0) return 0;
  return b < kNumCounters - 1 ? b : kNumCounters - 1;
}

void pbst_hist_record(uint64_t* buf, int64_t slot, uint64_t value,
                      int shift) {
  uint64_t* s = slot_ptr(buf, slot);
  write_begin(s);
  s[kHeaderWords + hist_bucket_of(value, shift)] += 1;
  write_end(s);
}

// Batched variant over parallel (slot, value) vectors: one C call per
// flushed staging slab instead of one interpreter round-trip per
// sample. Per-record seqlock discipline (see above). Slots are
// prevalidated against [0, total_slots) BEFORE any write so a bad
// batch mutates nothing; returns 0 ok / -2 slot out of range.
int pbst_hist_record_many(uint64_t* buf, int64_t total_slots,
                          const int64_t* slots, const uint64_t* values,
                          int n, int shift) {
  for (int i = 0; i < n; i++) {
    if (slots[i] < 0 || slots[i] >= total_slots) return -2;
  }
  for (int i = 0; i < n; i++) {
    uint64_t* s = slot_ptr(buf, slots[i]);
    write_begin(s);
    s[kHeaderWords + hist_bucket_of(values[i], shift)] += 1;
    write_end(s);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Lockless SPSC trace ring (xen/common/trace.c analog).
//
// Header (u64): [0] head (total records written)  [1] tail (consumed)
//               [2] capacity (records)            [3] lost
// Records: 8 u64 each: [timestamp_ns, event_id, a0..a5].
// Producer: the executor thread. Consumer: any monitor process mapping
// the same buffer (xentrace analog). head/tail are monotonic; index =
// value % capacity.
// ---------------------------------------------------------------------------

static const int kTraceHeaderWords = 4;
static const int kTraceRecWords = 8;

int pbst_trace_rec_words() { return kTraceRecWords; }
int pbst_trace_header_words() { return kTraceHeaderWords; }

void pbst_trace_init(uint64_t* buf, uint64_t capacity) {
  buf[0] = 0;
  buf[1] = 0;
  buf[2] = capacity;
  buf[3] = 0;
}

// Returns 1 if recorded, 0 if dropped (ring full -> lost++, matching
// trace.c's "lost records" accounting rather than blocking).
int pbst_trace_emit(uint64_t* buf, uint64_t ts_ns, uint64_t event,
                    uint64_t a0, uint64_t a1, uint64_t a2, uint64_t a3,
                    uint64_t a4, uint64_t a5) {
  uint64_t cap = buf[2];
  uint64_t head = __atomic_load_n(&buf[0], __ATOMIC_RELAXED);
  uint64_t tail = __atomic_load_n(&buf[1], __ATOMIC_ACQUIRE);
  if (head - tail >= cap) {
    __atomic_fetch_add(&buf[3], 1, __ATOMIC_RELAXED);
    return 0;
  }
  uint64_t* rec = buf + kTraceHeaderWords + (head % cap) * kTraceRecWords;
  rec[0] = ts_ns;
  rec[1] = event;
  rec[2] = a0; rec[3] = a1; rec[4] = a2;
  rec[5] = a3; rec[6] = a4; rec[7] = a5;
  __atomic_store_n(&buf[0], head + 1, __ATOMIC_RELEASE);
  return 1;
}

// Batched emit of n records (flat n*8 u64, caller-staged) in at most
// two wrap-aware memcpy spans — the EmitBatch flush becomes one C
// call. Returns records written; records that don't fit are dropped
// tail-first with the lost counter charged, exactly the drop
// semantics of n scalar pbst_trace_emit calls (and byte-identical to
// the Python emit_many fallback).
int pbst_trace_emit_many(uint64_t* buf, const uint64_t* recs, int n) {
  if (n <= 0) return 0;
  uint64_t cap = buf[2];
  uint64_t head = __atomic_load_n(&buf[0], __ATOMIC_RELAXED);
  uint64_t tail = __atomic_load_n(&buf[1], __ATOMIC_ACQUIRE);
  uint64_t space = cap - (head - tail);
  uint64_t k = (uint64_t)n <= space ? (uint64_t)n : space;
  if (k < (uint64_t)n) {
    __atomic_fetch_add(&buf[3], (uint64_t)n - k, __ATOMIC_RELAXED);
  }
  if (k == 0) return 0;
  uint64_t start = head % cap;
  uint64_t k1 = k <= cap - start ? k : cap - start;
  std::memcpy(buf + kTraceHeaderWords + start * kTraceRecWords, recs,
              k1 * kTraceRecWords * sizeof(uint64_t));
  if (k > k1) {
    std::memcpy(buf + kTraceHeaderWords, recs + k1 * kTraceRecWords,
                (k - k1) * kTraceRecWords * sizeof(uint64_t));
  }
  __atomic_store_n(&buf[0], head + k, __ATOMIC_RELEASE);
  return (int)k;
}

// Consume up to max_records into out (flat u64 array). Returns count.
int pbst_trace_consume(uint64_t* buf, uint64_t* out, int max_records) {
  uint64_t cap = buf[2];
  uint64_t tail = __atomic_load_n(&buf[1], __ATOMIC_RELAXED);
  uint64_t head = __atomic_load_n(&buf[0], __ATOMIC_ACQUIRE);
  int n = 0;
  while (tail < head && n < max_records) {
    const uint64_t* rec =
        buf + kTraceHeaderWords + (tail % cap) * kTraceRecWords;
    std::memcpy(out + n * kTraceRecWords, rec,
                kTraceRecWords * sizeof(uint64_t));
    tail++;
    n++;
  }
  __atomic_store_n(&buf[1], tail, __ATOMIC_RELEASE);
  return n;
}

uint64_t pbst_trace_lost(const uint64_t* buf) {
  return __atomic_load_n(&buf[3], __ATOMIC_RELAXED);
}

// ---------------------------------------------------------------------------
// Cross-process doorbells (event-channel shared page analog).
//
// Xen event channels notify across domains through pending bits in the
// shared_info page plus an upcall (xen/common/event_channel.c); the
// cross-process notify path here is the same shape over caller-provided
// shared memory: per-channel pending COUNTS (coalescing like the evtchn
// pending bit, but lossless for consumers that want the count) and one
// global notify sequence a waiter can block on.
//
// Layout (u64 words): [0] magic  [1] n_channels  [2] notify_seq
//                     [3] reserved  [4 .. 4+n) per-channel pending
// ---------------------------------------------------------------------------

static const uint64_t kDoorbellMagic = 0x70627374'6462ULL;  // "pbstdb"
static const int kDoorbellHeaderWords = 4;

int pbst_db_header_words() { return kDoorbellHeaderWords; }

void pbst_db_init(uint64_t* buf, uint64_t n_channels) {
  buf[1] = n_channels;
  buf[2] = 0;
  buf[3] = 0;
  std::memset(buf + kDoorbellHeaderWords, 0,
              n_channels * sizeof(uint64_t));
  __atomic_store_n(&buf[0], kDoorbellMagic, __ATOMIC_RELEASE);
}

int pbst_db_valid(const uint64_t* buf) {
  return __atomic_load_n(&buf[0], __ATOMIC_ACQUIRE) == kDoorbellMagic;
}

// Ring a channel: bump its pending count and the notify sequence.
// Returns the channel's new pending count, or 0 on a bad channel.
uint64_t pbst_db_send(uint64_t* buf, uint64_t chan) {
  if (chan >= buf[1]) return 0;
  uint64_t n = __atomic_add_fetch(&buf[kDoorbellHeaderWords + chan], 1,
                                  __ATOMIC_RELEASE);
  __atomic_add_fetch(&buf[2], 1, __ATOMIC_RELEASE);
  return n;
}

uint64_t pbst_db_pending(const uint64_t* buf, uint64_t chan) {
  if (chan >= buf[1]) return 0;
  return __atomic_load_n(&buf[kDoorbellHeaderWords + chan],
                         __ATOMIC_ACQUIRE);
}

// Consume a channel: atomically take (and zero) its pending count —
// the edge-triggered clear-on-dispatch step.
uint64_t pbst_db_take(uint64_t* buf, uint64_t chan) {
  if (chan >= buf[1]) return 0;
  return __atomic_exchange_n(&buf[kDoorbellHeaderWords + chan], 0,
                             __ATOMIC_ACQ_REL);
}

uint64_t pbst_db_seq(const uint64_t* buf) {
  return __atomic_load_n(&buf[2], __ATOMIC_ACQUIRE);
}

}  // extern "C"

#include <time.h>

extern "C" {

// Block until notify_seq differs from last_seq or timeout_us elapses.
// Adaptive: brief spin (latency), then 50 us sleeps (CPU). Returns the
// current notify_seq either way — the caller compares with last_seq.
uint64_t pbst_db_wait(const uint64_t* buf, uint64_t last_seq,
                      uint64_t timeout_us) {
  for (int i = 0; i < 1024; i++) {  // spin phase: ~tens of us
    uint64_t s = __atomic_load_n(&buf[2], __ATOMIC_ACQUIRE);
    if (s != last_seq) return s;
  }
  struct timespec start, now;
  clock_gettime(CLOCK_MONOTONIC, &start);
  struct timespec nap = {0, 50 * 1000};  // 50 us
  for (;;) {
    uint64_t s = __atomic_load_n(&buf[2], __ATOMIC_ACQUIRE);
    if (s != last_seq) return s;
    clock_gettime(CLOCK_MONOTONIC, &now);
    // Signed arithmetic: when the window crosses a whole-second
    // boundary, tv_nsec goes BACKWARD and an unsigned delta wraps to
    // ~2^54 us, returning the wait early — seen as the tier-1
    // test_wait_returns_on_ring_and_timeout flake (any 0.2 s wait had
    // a ~20% chance of straddling a second edge).
    int64_t el = (int64_t)(now.tv_sec - start.tv_sec) * 1000000LL +
                 ((int64_t)now.tv_nsec - (int64_t)start.tv_nsec) / 1000LL;
    if (el >= (int64_t)timeout_us) return s;
    nanosleep(&nap, nullptr);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Data-loader gather.
//
// The reference's I/O data plane moves bytes with zero-copy grant
// mappings (blkfront/blkback); PBS-T's input pipeline moves token rows
// from a memory-mapped corpus into a staging buffer the host then
// copies to the device. The gather is the per-batch hot loop: one memcpy per
// sequence, no Python per-row overhead.

extern "C" {

// Copy n rows of row_bytes each from base+offsets[i] into out
// (contiguous). Returns n, or -1 if any row would exceed base_len.
int pbst_gather_rows(const uint8_t* base, uint64_t base_len,
                     const uint64_t* offsets, int n, uint64_t row_bytes,
                     uint8_t* out) {
  // Overflow-safe bound: offsets[i] + row_bytes could wrap in u64.
  if (row_bytes > base_len) return -1;
  for (int i = 0; i < n; ++i) {
    if (offsets[i] > base_len - row_bytes) return -1;
  }
  for (int i = 0; i < n; ++i) {
    std::memcpy(out + (uint64_t)i * row_bytes, base + offsets[i], row_bytes);
  }
  return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Sweep-mode sim dispatch core (pbst_sim_run).
//
// The paper compiles perfctr straight into the hypervisor; the sim's
// analog is this C quantum loop owning the timer wheel, the credit
// run-queue and the per-context accounting for the hot policies
// (credit, feedback, atc) — the Python dispatch frames of each
// quantum (executor + scheduler + backend) collapse to a C loop.
//
// EQUIVALENCE IS THE CONTRACT:
// every arithmetic expression below mirrors the Python engine
// bit-for-bit — float64 op order, int() truncation toward zero,
// round-half-even for quantum->steps, numpy's pairwise summation for
// the stability window — and the jitter stream is the engine's own
// numpy Generator.random(n) bit stream, pre-drawn by the Python side
// into per-job buffers (the C side only consumes). The Python engine
// stays as the witness: tests/test_torch_native_sim.py pins bit-identical
// trace digests and metrics reports across tiers over the full
// (workload x policy) catalog, exactly like ListSchedulerProbe pins
// SchedulerProbe.
//
// ALL mutable state lives in caller-provided numpy buffers: the
// function is a pure transition over the state block, the Python side
// reads results straight out of the arrays, and no allocation happens
// here. One call runs the whole horizon (capacities are hard-bounded
// by the caller; an overflow is a negative status, never a write past
// the end).
// ---------------------------------------------------------------------------

#include <math.h>

namespace pbst_sim {

// gs[] global scalar slots (keep in lockstep with sim/native_core.py).
enum {
  GS_N_JOBS = 0, GS_UNTIL_NS, GS_POLICY, GS_NOW_NS, GS_NEXT_SEQ,
  GS_HEAP_LEN, GS_HEAP_CAP, GS_RUNQ_LEN, GS_SWITCHES, GS_LAST_PICK,
  GS_DISPATCHES, GS_SCHED_INVOC, GS_ACCT_PERIOD_US, GS_ACCT_COUNT,
  GS_TICK_NS, GS_WINDOW_LEN, GS_STALE_AFTER, GS_FALLBACK_US,
  GS_MIN_US, GS_MAX_US, GS_GROW_STEP_US, GS_SHRINK_SUB_US,
  GS_TIMELINE, GS_RECORD, GS_EV_LEN, GS_EV_CAP, GS_STATUS,
  GS_STATUS_ARG, GS_WORDS
};

// gf[] global float slots.
enum { GF_CLIP = 0, GF_CREDIT_TOTAL, GF_STALL_THRESHOLD, GF_WORDS };

// js[] per-job i64 slots (stride JS_WORDS).
enum {
  J_WEIGHT = 0, J_CAP, J_TSLICE_US, J_BOOST, J_STATE, J_PRI, J_PARKED,
  J_ACTIVE, J_SCHED_COUNT, J_STEPS_DONE, J_PH_OFF, J_N_PHASES,
  J_STEADY, J_PH_IDX, J_PH_LEFT, J_RNG_POS, J_RNG_LEN, J_ENQ_TS,
  J_ENQ_SET, J_WAIT_N, J_WAIT_CAP, J_DISPATCHES, J_QT_N, J_QT_CAP,
  J_LAST_Q, J_WFILL, J_PHASE, J_TICKS, J_GROWS, J_SHRINKS, J_RESETS,
  J_STALE_TICKS, J_FALLBACKS, J_HFILL, J_APPLIED_BUCKET, J_WAIT_ACC,
  JS_WORDS
};

// jf[] per-job f64 slots (stride JF_WORDS).
enum {
  JF_CREDIT = 0, JF_SPENT_US, JF_AVG_STEP_NS, JF_STALL_RATE, JF_NSPI,
  JF_EWMA, JF_WORDS
};

// Phase table strides: ph_i rows [steps, step_time_ns, hbm_bytes,
// coll_wait_ns, flops, tokens], ph_f rows [stall_frac, jitter].
enum { PH_I_WORDS = 6, PH_F_WORDS = 2 };
enum { PHI_STEPS = 0, PHI_STEP_NS, PHI_HBM, PHI_COLL, PHI_FLOPS,
       PHI_TOKENS };
enum { PHF_STALL = 0, PHF_JITTER };

// Timer heap rows: [when_ns, seq, kind, arg]. Pop order is (when, seq)
// — the Python TimerWheel's heap key — so fire order matches exactly.
enum { HP_WORDS = 4 };
enum { HP_WHEN = 0, HP_SEQ, HP_KIND, HP_ARG };
enum { TK_ACCT = 0, TK_TICK, TK_WAKE, TK_SLEEP };

// ContextState encoding shared with sim/native_core.py.
enum { ST_RUNNABLE = 0, ST_RUNNING, ST_BLOCKED, ST_PARKED, ST_DONE };

// Credit priorities (sched/credit.py PRI_*).
enum { PRI_BOOST = 0, PRI_UNDER = -1, PRI_OVER = -2 };

enum { POL_CREDIT = 0, POL_FEEDBACK = 1, POL_ATC = 2 };

// Event log rows (record mode), stride EV_WORDS:
//   quantum: [0, t0, end, q_ns, n, job, dev, hbm, stall, coll, flops,
//             steps, tokens, 0]
//   tick:    [1, t, job, phase, stall_x1000, nspi_x1000, tslice_us,
//             grows, shrinks, resets, 0...]
enum { EV_WORDS = 14 };

// Counter slots touched (telemetry/counters.py).
enum {
  C_STEPS = 0, C_DEV = 1, C_HBM = 2, C_STALL = 3, C_COLL = 4,
  C_RUNQ_WAIT = 14, C_SCHED_COUNT = 15, C_FLOPS = 8, C_TOKENS = 16,
  C_NUM = 18
};

enum {
  SIM_OK = 0, SIM_ERR_RNG = -1, SIM_ERR_WAIT = -2, SIM_ERR_TIMELINE = -3,
  SIM_ERR_EVENT = -4, SIM_ERR_RUNQ = -5, SIM_ERR_HEAP = -6,
  SIM_ERR_CLOCK = -7
};

// Status codes / word counts exported so the Python side can assert
// the ABI it marshals against is the ABI the .so was built with.
enum { SIM_ABI_VERSION = 1 };

// numpy's pairwise float64 sum for n <= 128 (umath loops pairwise_sum):
// sequential below 8 elements, the 8-accumulator tree otherwise. The
// feedback stability window is summed with THIS estimator in Python
// (w.sum()), and for window_len = 8 (a tuned-profile value) the tree
// differs from sequential addition in the last ulp — which a digest
// notices.
static double np_pairwise_sum(const double* a, int64_t n) {
  if (n < 8) {
    double res = 0.0;
    for (int64_t i = 0; i < n; i++) res += a[i];
    return res;
  }
  double r[8];
  for (int i = 0; i < 8; i++) r[i] = a[i];
  int64_t i = 8;
  for (; i + 8 <= n; i += 8) {
    for (int k = 0; k < 8; k++) r[k] += a[i + k];
  }
  double res = ((r[0] + r[1]) + (r[2] + r[3])) +
               ((r[4] + r[5]) + (r[6] + r[7]));
  for (; i < n; i++) res += a[i];
  return res;
}

struct Sim {
  int64_t* gs;
  double* gf;
  int64_t* js;
  double* jf;
  uint64_t* counters;  // (n_jobs, 18)
  uint64_t* prev;      // (n_jobs, 18)
  const int64_t* ph_i;
  const double* ph_f;
  int64_t* heap;       // (heap_cap, 4)
  int64_t* runq;       // (n_jobs,)
  double* window;      // (n_jobs, window_len)
  int64_t* hist;       // (n_jobs, 4) atc bucket history
  // Per-job buffer tables: u64 addresses of the numpy arrays the
  // Python side owns (read as integers, converted per access — the
  // one portable way to smuggle a pointer vector through a u64 ABI).
  const uint64_t* rng_tab;  // pre-drawn Generator.random streams
  const uint64_t* wt_tab;   // dispatch timestamps
  const uint64_t* ww_tab;   // wait samples
  const uint64_t* qt_tab;   // quantum-timeline timestamps
  const uint64_t* qq_tab;   // quantum-timeline values (us)
  int64_t* ev;              // event log (record mode)
  int64_t n;                // n_jobs
  int64_t now;
  int64_t status;

  int64_t* J(int64_t j) { return js + j * JS_WORDS; }
  double* F(int64_t j) { return jf + j * JF_WORDS; }
  uint64_t* C(int64_t j) { return counters + j * C_NUM; }
  uint64_t* P(int64_t j) { return prev + j * C_NUM; }
  const double* rng_of(int64_t j) {
    return (const double*)(uintptr_t)rng_tab[j];
  }
  int64_t* wt_of(int64_t j) { return (int64_t*)(uintptr_t)wt_tab[j]; }
  int64_t* ww_of(int64_t j) { return (int64_t*)(uintptr_t)ww_tab[j]; }
  int64_t* qt_of(int64_t j) { return (int64_t*)(uintptr_t)qt_tab[j]; }
  int64_t* qq_of(int64_t j) { return (int64_t*)(uintptr_t)qq_tab[j]; }

  // -- timer wheel ----------------------------------------------------

  bool heap_less(int64_t a, int64_t b) {
    const int64_t* ra = heap + a * HP_WORDS;
    const int64_t* rb = heap + b * HP_WORDS;
    if (ra[HP_WHEN] != rb[HP_WHEN]) return ra[HP_WHEN] < rb[HP_WHEN];
    return ra[HP_SEQ] < rb[HP_SEQ];
  }

  void heap_swap(int64_t a, int64_t b) {
    int64_t* ra = heap + a * HP_WORDS;
    int64_t* rb = heap + b * HP_WORDS;
    for (int k = 0; k < HP_WORDS; k++) {
      int64_t t = ra[k]; ra[k] = rb[k]; rb[k] = t;
    }
  }

  bool heap_push(int64_t when, int64_t kind, int64_t arg) {
    int64_t len = gs[GS_HEAP_LEN];
    if (len >= gs[GS_HEAP_CAP]) { status = SIM_ERR_HEAP; return false; }
    int64_t* r = heap + len * HP_WORDS;
    r[HP_WHEN] = when;
    r[HP_SEQ] = gs[GS_NEXT_SEQ]++;
    r[HP_KIND] = kind;
    r[HP_ARG] = arg;
    gs[GS_HEAP_LEN] = ++len;
    int64_t i = len - 1;
    while (i > 0) {
      int64_t p = (i - 1) / 2;
      if (!heap_less(i, p)) break;
      heap_swap(i, p);
      i = p;
    }
    return true;
  }

  void heap_pop(int64_t* out) {
    int64_t len = gs[GS_HEAP_LEN];
    for (int k = 0; k < HP_WORDS; k++) out[k] = heap[k];
    len--;
    if (len > 0) {
      int64_t* last = heap + len * HP_WORDS;
      for (int k = 0; k < HP_WORDS; k++) heap[k] = last[k];
      int64_t i = 0;
      for (;;) {
        int64_t l = 2 * i + 1, r = 2 * i + 2, m = i;
        if (l < len && heap_less(l, m)) m = l;
        if (r < len && heap_less(r, m)) m = r;
        if (m == i) break;
        heap_swap(i, m);
        i = m;
      }
    }
    gs[GS_HEAP_LEN] = len;
  }

  // Rebuild heap order from the caller's arming-ordered rows (pushing
  // in increasing seq yields a valid heap via sift-up).
  void heapify_initial() {
    int64_t len = gs[GS_HEAP_LEN];
    for (int64_t i = 1; i < len; i++) {
      int64_t c = i;
      while (c > 0) {
        int64_t p = (c - 1) / 2;
        if (!heap_less(c, p)) break;
        heap_swap(c, p);
        c = p;
      }
    }
  }

  // -- run queue (single executor, FIFO within priority class) --------

  void runq_insert(int64_t j) {
    int64_t len = gs[GS_RUNQ_LEN];
    if (len >= n) { status = SIM_ERR_RUNQ; return; }
    int64_t pri = J(j)[J_PRI];
    int64_t i = 0;
    while (i < len && J(runq[i])[J_PRI] >= pri) i++;
    for (int64_t k = len; k > i; k--) runq[k] = runq[k - 1];
    runq[i] = j;
    gs[GS_RUNQ_LEN] = len + 1;
  }

  void runq_remove(int64_t j) {
    int64_t len = gs[GS_RUNQ_LEN];
    for (int64_t i = 0; i < len; i++) {
      if (runq[i] == j) {
        for (int64_t k = i; k < len - 1; k++) runq[k] = runq[k + 1];
        gs[GS_RUNQ_LEN] = len - 1;
        return;
      }
    }
  }

  bool in_runq(int64_t j) {
    for (int64_t i = 0; i < gs[GS_RUNQ_LEN]; i++)
      if (runq[i] == j) return true;
    return false;
  }

  // -- run-state control (wake_job / sleep_job, notify=False) ----------

  void wake_job(int64_t j) {
    int64_t* s = J(j);
    if (s[J_STATE] != ST_BLOCKED) return;
    s[J_STATE] = ST_RUNNABLE;
    // probe.wake: _enqueued.setdefault(ctx, now)
    if (!s[J_ENQ_SET]) { s[J_ENQ_SET] = 1; s[J_ENQ_TS] = now; }
    // credit wake
    if (in_runq(j)) return;
    if (s[J_PARKED]) return;
    if (s[J_BOOST] && F(j)[JF_CREDIT] >= 0) s[J_PRI] = PRI_BOOST;
    s[J_ACTIVE] = 1;
    runq_insert(j);
  }

  void sleep_job(int64_t j) {
    int64_t* s = J(j);
    if (s[J_STATE] != ST_RUNNABLE && s[J_STATE] != ST_RUNNING) return;
    s[J_STATE] = ST_BLOCKED;
    s[J_ENQ_SET] = 0;  // probe.sleep: _enqueued.pop
    runq_remove(j);    // credit sleep
  }

  // -- csched_acct (sched/credit.py _acct) -----------------------------

  void do_acct() {
    gs[GS_ACCT_COUNT]++;
    int64_t wt_total = 0;
    for (int64_t j = 0; j < n; j++)
      if (J(j)[J_ACTIVE]) wt_total += J(j)[J_WEIGHT];
    if (wt_total <= 0) return;
    double clip = gf[GF_CLIP];
    double period_us = (double)gs[GS_ACCT_PERIOD_US];
    for (int64_t j = 0; j < n; j++) {
      int64_t* s = J(j);
      if (!s[J_ACTIVE]) continue;
      double fair = gf[GF_CREDIT_TOTAL] * (double)s[J_WEIGHT] /
                    (double)wt_total;
      if (s[J_CAP] > 0) {
        double cap_credit = ((double)s[J_CAP] / 100.0) * period_us;
        if (cap_credit < fair) fair = cap_credit;
      }
      if (s[J_STATE] == ST_DONE) {  // no non-DONE contexts left
        s[J_ACTIVE] = 0;
        continue;
      }
      double share = fair;  // one context per job
      double* f = F(j);
      double c = f[JF_CREDIT] + share;
      f[JF_CREDIT] = c < clip ? c : clip;
      s[J_PRI] = f[JF_CREDIT] >= 0 ? PRI_UNDER : PRI_OVER;
      if (s[J_PARKED] && f[JF_CREDIT] >= 0) {
        s[J_PARKED] = 0;
        s[J_STATE] = ST_RUNNABLE;
        runq_insert(j);
      }
      bool any_runnable =
          s[J_STATE] == ST_RUNNABLE || s[J_STATE] == ST_RUNNING ||
          s[J_PARKED];
      if (!any_runnable && f[JF_SPENT_US] == 0.0) s[J_ACTIVE] = 0;
      f[JF_SPENT_US] = 0.0;
    }
  }

  // -- feedback policy (sched/feedback.py / sched/atc.py) --------------

  int64_t clamp_band(int64_t us) {
    if (us < gs[GS_MIN_US]) return gs[GS_MIN_US];
    if (us > gs[GS_MAX_US]) return gs[GS_MAX_US];
    return us;
  }

  void grow(int64_t j) {
    int64_t* s = J(j);
    int64_t nu = clamp_band(s[J_TSLICE_US] + gs[GS_GROW_STEP_US]);
    if (nu != s[J_TSLICE_US]) s[J_GROWS]++;
    s[J_TSLICE_US] = nu;
  }

  void shrink(int64_t j) {
    int64_t* s = J(j);
    int64_t cur = s[J_TSLICE_US];
    int64_t third = cur / 3;  // cur >= 0: same as Python floor div
    int64_t nu = third >= gs[GS_MIN_US] ? third
                                        : cur - gs[GS_SHRINK_SUB_US];
    nu = clamp_band(nu);
    if (nu != cur) s[J_SHRINKS]++;
    s[J_TSLICE_US] = nu;
  }

  void submilli_feedback(int64_t j, double coll_ns, int64_t steps) {
    int64_t* s = J(j);
    double* f = F(j);
    // take_contention() is (0, 0) in the sim: no gateway reports.
    double total_wait = coll_ns;
    int64_t total_events = coll_ns > 0 ? steps : 0;
    if (total_events < 1) total_events = 1;
    double sample = total_wait / (double)total_events;

    int64_t wlen = gs[GS_WINDOW_LEN];
    double* w = window + j * wlen;
    if (s[J_WFILL] < wlen) {
      w[s[J_WFILL]++] = sample;
      if (s[J_WFILL] < wlen) return;
    } else {
      for (int64_t i = 0; i + 1 < wlen; i++) w[i] = w[i + 1];
      w[wlen - 1] = sample;
    }

    double mean = np_pairwise_sum(w, wlen) / (double)wlen;
    bool stable = true;
    if (mean > 0) {
      double lo = 0.70 * mean;
      double hi = 1.30 * mean;
      for (int64_t i = 0; i < wlen; i++) {
        if (w[i] < lo || w[i] > hi) { stable = false; break; }
      }
    }
    if (stable) {
      if (f[JF_STALL_RATE] >= gf[GF_STALL_THRESHOLD]) {
        s[J_PHASE] = 0;  // LOW_PHASE: grow
        grow(j);
      } else {
        s[J_PHASE] = 1;  // HIGH_PHASE: shrink
        shrink(j);
      }
    } else {
      bool rising = w[wlen - 1] > mean;
      s[J_WFILL] = 0;
      s[J_RESETS]++;
      if (rising) shrink(j);
    }
  }

  void atc_apply_global_min() {
    // Clamped to the atc MODULE constants (ATC_MIN_US/ATC_MAX_US,
    // sched/atc.py:112-113), NOT the policy's tunable band — a tuned
    // min_us/max_us narrows the quantum law's band in neither engine.
    const int64_t NONE = INT64_MIN;
    int64_t best = NONE;
    for (int64_t k = 0; k < n; k++) {
      int64_t ab = J(k)[J_APPLIED_BUCKET];
      if (ab == NONE) continue;
      int64_t us = 49980 - 3300 * ab;
      if (us < 300) us = 300;        // ATC_MIN_US
      if (us > 30000) us = 30000;    // ATC_MAX_US
      if (best == NONE || us < best) best = us;
    }
    if (best == NONE) return;
    for (int64_t k = 0; k < n; k++) J(k)[J_TSLICE_US] = best;
  }

  void submilli_atc(int64_t j, double coll_ns, int64_t steps) {
    int64_t* s = J(j);
    double* f = F(j);
    double total_wait = coll_ns;
    int64_t total_events = coll_ns > 0 ? steps : 0;
    if (total_events < 1) total_events = 1;
    double sample = total_wait / (double)total_events;

    f[JF_EWMA] = (f[JF_EWMA] * 3.0 + sample) / 4.0;  // ALPHA = 4
    int64_t bucket =
        f[JF_EWMA] >= 1 ? (int64_t)log2(f[JF_EWMA]) : 0;
    int64_t* h = hist + j * 4;
    if (s[J_HFILL] < 4) {
      h[s[J_HFILL]++] = bucket;
    } else {
      h[0] = h[1]; h[1] = h[2]; h[2] = h[3]; h[3] = bucket;
    }
    if (s[J_HFILL] == 4 && h[0] == h[1] && h[1] == h[2] && h[2] == h[3])
      s[J_APPLIED_BUCKET] = bucket;
    atc_apply_global_min();
  }

  bool ev_append_tick(int64_t j) {
    if (gs[GS_EV_LEN] >= gs[GS_EV_CAP]) {
      status = SIM_ERR_EVENT;
      return false;
    }
    int64_t* s = J(j);
    double* f = F(j);
    int64_t* r = ev + gs[GS_EV_LEN]++ * EV_WORDS;
    r[0] = 1;
    r[1] = now;
    r[2] = j;
    r[3] = s[J_PHASE];
    r[4] = (int64_t)(f[JF_STALL_RATE] * 1000.0);  // int() truncation
    r[5] = (int64_t)(f[JF_NSPI] * 1000.0);
    r[6] = s[J_TSLICE_US];
    r[7] = s[J_GROWS];
    r[8] = s[J_SHRINKS];
    r[9] = s[J_RESETS];
    for (int k = 10; k < EV_WORDS; k++) r[k] = 0;
    return true;
  }

  void do_tick() {
    bool atc = gs[GS_POLICY] == POL_ATC;
    for (int64_t j = 0; j < n; j++) {
      int64_t* s = J(j);
      s[J_TICKS]++;
      uint64_t* c = C(j);
      uint64_t* p = P(j);
      uint64_t d[C_NUM];
      for (int k = 0; k < C_NUM; k++) {
        d[k] = c[k] - p[k];
        p[k] = c[k];
      }
      int64_t steps = (int64_t)d[C_STEPS];
      int64_t dev = (int64_t)d[C_DEV];
      int64_t stall = (int64_t)d[C_STALL];
      int64_t coll = (int64_t)d[C_COLL];
      if (steps == 0 && dev == 0) continue;  // idle: nothing to learn
      if (steps > 0 && dev == 0) {
        // Dead readout: never steer on it (sched/feedback.py).
        s[J_STALE_TICKS]++;
        if (s[J_STALE_TICKS] == gs[GS_STALE_AFTER]) {
          s[J_WFILL] = 0;
          s[J_FALLBACKS]++;
          s[J_TSLICE_US] = gs[GS_FALLBACK_US];
        }
        continue;
      }
      s[J_STALE_TICKS] = 0;
      double* f = F(j);
      if (dev > 0)
        f[JF_STALL_RATE] = (double)stall * 1000.0 / (double)dev;
      if (steps > 0) f[JF_NSPI] = (double)dev / (double)steps;
      if (atc)
        submilli_atc(j, (double)coll, steps);
      else
        submilli_feedback(j, (double)coll, steps);
      if (gs[GS_RECORD] && !ev_append_tick(j)) return;
    }
  }

  // -- timer dispatch (runtime/timer.py fire_due) ----------------------

  bool fire_due() {
    if (gs[GS_HEAP_LEN] == 0 || heap[HP_WHEN] > now) return true;
    while (gs[GS_HEAP_LEN] > 0 && heap[HP_WHEN] <= now) {
      int64_t rec[HP_WORDS];
      heap_pop(rec);
      // Re-arm periodic timers BEFORE firing (timer.py fire_due).
      if (rec[HP_KIND] == TK_ACCT) {
        if (!heap_push(rec[HP_WHEN] + gs[GS_ACCT_PERIOD_US] * 1000,
                       TK_ACCT, 0))
          return false;
        do_acct();
      } else if (rec[HP_KIND] == TK_TICK) {
        if (!heap_push(rec[HP_WHEN] + gs[GS_TICK_NS], TK_TICK, 0))
          return false;
        do_tick();
        if (status != SIM_OK) return false;
      } else if (rec[HP_KIND] == TK_WAKE) {
        wake_job(rec[HP_ARG]);
        if (status != SIM_OK) return false;
      } else {
        sleep_job(rec[HP_ARG]);
      }
    }
    return status == SIM_OK;
  }

  int64_t next_deadline(bool* has) {
    *has = gs[GS_HEAP_LEN] > 0;
    return *has ? heap[HP_WHEN] : 0;
  }

  bool pending_work() {
    for (int64_t j = 0; j < n; j++) {
      int64_t st = J(j)[J_STATE];
      if (st == ST_RUNNABLE || st == ST_RUNNING || st == ST_PARKED)
        return true;
    }
    return false;
  }

  // -- SimBackend.execute (telemetry/source.py) ------------------------

  bool execute(int64_t j, int64_t n_steps, uint64_t d[C_NUM]) {
    int64_t* s = J(j);
    int64_t t_tot = 0, hbm = 0, stall = 0, coll = 0, flops = 0,
            tokens = 0;
    if (s[J_STEADY]) {
      const int64_t* pi = ph_i + s[J_PH_OFF] * PH_I_WORDS;
      const double* pf = ph_f + s[J_PH_OFF] * PH_F_WORDS;
      int64_t base = pi[PHI_STEP_NS];
      if (base < 1) base = 1;
      double jit = pf[PHF_JITTER];
      double frac = pf[PHF_STALL];
      int64_t cw = pi[PHI_COLL];
      hbm = pi[PHI_HBM] * n_steps;
      flops = pi[PHI_FLOPS] * n_steps;
      tokens = pi[PHI_TOKENS] * n_steps;
      if (jit > 0.0) {
        int64_t need = (cw > 0 ? 2 : 1) * n_steps;
        if (s[J_RNG_POS] + need > s[J_RNG_LEN]) {
          status = SIM_ERR_RNG;
          gs[GS_STATUS_ARG] = j;
          return false;
        }
        const double* r = rng_of(j) + s[J_RNG_POS];
        s[J_RNG_POS] += need;
        double dbase = (double)base;
        double dcw = (double)cw;
        if (cw > 0) {
          for (int64_t k = 0; k < n_steps; k++) {
            int64_t t =
                (int64_t)(dbase * (1.0 + jit * (2.0 * r[2 * k] - 1.0)));
            if (t < 1) t = 1;
            t_tot += t;
            stall += (int64_t)((double)t * frac);
            int64_t c = (int64_t)(
                dcw * (1.0 + jit * (2.0 * r[2 * k + 1] - 1.0)));
            if (c < 1) c = 1;
            coll += c;
          }
        } else {
          for (int64_t k = 0; k < n_steps; k++) {
            int64_t t =
                (int64_t)(dbase * (1.0 + jit * (2.0 * r[k] - 1.0)));
            if (t < 1) t = 1;
            t_tot += t;
            stall += (int64_t)((double)t * frac);
          }
        }
      } else {
        t_tot = base * n_steps;
        stall = (int64_t)((double)base * frac) * n_steps;
        coll = cw * n_steps;
      }
      s[J_STEPS_DONE] += n_steps;
    } else {
      // Multi-phase schedule: cursor (J_PH_IDX, J_PH_LEFT) walks the
      // profile exactly as SimProfile.phase_at(steps_done) resolves.
      if (s[J_RNG_POS] + 2 * n_steps > s[J_RNG_LEN]) {
        // Conservative: at most 2 draws per step.
        bool any_jit = false;
        for (int64_t q = 0; q < s[J_N_PHASES]; q++) {
          if (ph_f[(s[J_PH_OFF] + q) * PH_F_WORDS + PHF_JITTER] > 0.0)
            any_jit = true;
        }
        if (any_jit) {
          status = SIM_ERR_RNG;
          gs[GS_STATUS_ARG] = j;
          return false;
        }
      }
      for (int64_t k = 0; k < n_steps; k++) {
        const int64_t* pi =
            ph_i + (s[J_PH_OFF] + s[J_PH_IDX]) * PH_I_WORDS;
        const double* pf =
            ph_f + (s[J_PH_OFF] + s[J_PH_IDX]) * PH_F_WORDS;
        double jit = pf[PHF_JITTER];
        int64_t t = pi[PHI_STEP_NS];
        if (t < 1) t = 1;
        if (jit > 0.0) {
          double r = rng_of(j)[s[J_RNG_POS]++];
          t = (int64_t)((double)t * (1.0 + jit * (2.0 * r - 1.0)));
          if (t < 1) t = 1;
        }
        int64_t c = pi[PHI_COLL];
        if (c > 0 && jit > 0.0) {
          double r = rng_of(j)[s[J_RNG_POS]++];
          c = (int64_t)((double)c * (1.0 + jit * (2.0 * r - 1.0)));
          if (c < 1) c = 1;
        }
        t_tot += t;
        hbm += pi[PHI_HBM];
        stall += (int64_t)((double)t * pf[PHF_STALL]);
        coll += c;
        flops += pi[PHI_FLOPS];
        tokens += pi[PHI_TOKENS];
        s[J_STEPS_DONE]++;
        if (s[J_PH_LEFT] > 0) {
          s[J_PH_LEFT]--;
          if (s[J_PH_LEFT] == 0 && s[J_PH_IDX] + 1 < s[J_N_PHASES]) {
            s[J_PH_IDX]++;
            s[J_PH_LEFT] =
                ph_i[(s[J_PH_OFF] + s[J_PH_IDX]) * PH_I_WORDS +
                     PHI_STEPS];
          }
        }
      }
    }
    now += t_tot;  // clock.advance
    d[C_STEPS] = (uint64_t)n_steps;
    d[C_DEV] = (uint64_t)t_tot;
    d[C_HBM] = (uint64_t)hbm;
    d[C_STALL] = (uint64_t)stall;
    d[C_COLL] = (uint64_t)coll;
    d[C_FLOPS] = (uint64_t)flops;
    d[C_TOKENS] = (uint64_t)tokens;
    return true;
  }

  // -- one dispatched quantum (runtime/executor.py _run) ---------------

  bool run_quantum(int64_t j, int64_t q_ns) {
    int64_t* s = J(j);
    s[J_STATE] = ST_RUNNING;
    s[J_SCHED_COUNT]++;
    gs[GS_DISPATCHES]++;
    // quantum -> steps (inlined quantum_to_steps; round-half-even).
    double avg = F(j)[JF_AVG_STEP_NS];
    int64_t n_units;
    if (avg <= 0) {
      n_units = 1;
    } else {
      n_units = (int64_t)rint((double)q_ns / avg);
      if (n_units < 1) n_units = 1;
      else if (n_units > 1024) n_units = 1024;  // MAX_STEPS_PER_QUANTUM
    }
    int64_t t0 = now;
    uint64_t d[C_NUM] = {0};
    if (!execute(j, n_units, d)) return false;
    int64_t ran_ns = (int64_t)d[C_DEV];
    d[C_SCHED_COUNT] = 1;
    uint64_t* c = C(j);
    for (int k = 0; k < C_NUM; k++) c[k] += d[k];
    // observe_step_time: EWMA alpha=0.25 (runtime/job.py).
    if (ran_ns > 0) {
      double per = (double)ran_ns / (double)n_units;
      F(j)[JF_AVG_STEP_NS] = 0.75 * F(j)[JF_AVG_STEP_NS] + 0.25 * per;
    }
    int64_t end = now;
    if (gs[GS_RECORD]) {
      if (gs[GS_EV_LEN] >= gs[GS_EV_CAP]) {
        status = SIM_ERR_EVENT;
        return false;
      }
      int64_t* r = ev + gs[GS_EV_LEN]++ * EV_WORDS;
      r[0] = 0;
      r[1] = t0;
      r[2] = end;
      r[3] = q_ns;
      r[4] = n_units;
      r[5] = j;
      r[6] = (int64_t)d[C_DEV];
      r[7] = (int64_t)d[C_HBM];
      r[8] = (int64_t)d[C_STALL];
      r[9] = (int64_t)d[C_COLL];
      r[10] = (int64_t)d[C_FLOPS];
      r[11] = (int64_t)d[C_STEPS];
      r[12] = (int64_t)d[C_TOKENS];
      r[13] = 0;
    }
    if (!fire_due()) return false;  // timers fire BEFORE descheduled
    // credit.descheduled: burn_credits.
    double ran_us = (double)ran_ns / 1000.0;
    double* f = F(j);
    f[JF_CREDIT] -= ran_us;
    f[JF_SPENT_US] += ran_us;
    s[J_ACTIVE] = 1;
    if (s[J_PRI] == PRI_BOOST) s[J_PRI] = PRI_UNDER;
    if (f[JF_CREDIT] < 0) s[J_PRI] = PRI_OVER;
    bool parked_now = false;
    if (s[J_CAP] > 0 &&
        f[JF_CREDIT] <
            -((double)s[J_CAP] / 100.0) * (double)gs[GS_ACCT_PERIOD_US]) {
      s[J_PARKED] = 1;
      s[J_STATE] = ST_PARKED;
      parked_now = true;
    }
    if (!parked_now &&
        (s[J_STATE] == ST_RUNNABLE || s[J_STATE] == ST_RUNNING)) {
      runq_insert(j);  // no yield path in the sim
      if (status != SIM_OK) return false;
    }
    // probe.descheduled: requeue timestamp.
    if (s[J_STATE] == ST_RUNNABLE || s[J_STATE] == ST_RUNNING) {
      s[J_ENQ_TS] = end;
      s[J_ENQ_SET] = 1;
    }
    if (s[J_STATE] == ST_RUNNING) s[J_STATE] = ST_RUNNABLE;
    return true;
  }

  // -- the loop (runtime/partition.py run + executor schedule_once) ----

  void run() {
    int64_t until = gs[GS_UNTIL_NS];
    while (status == SIM_OK) {
      if (now >= until) break;
      if (!fire_due()) break;
      gs[GS_SCHED_INVOC]++;
      // credit.do_schedule: peek head (single executor: no steal).
      if (gs[GS_RUNQ_LEN] == 0) {
        if (!pending_work()) break;
        bool has;
        int64_t dl = next_deadline(&has);
        if (!has) break;
        if (dl > now) now = dl;  // event-driven jump
        if (!fire_due()) break;
        continue;
      }
      int64_t j = runq[0];
      // remove-from-queue + Decision (clamp_tslice_us * US).
      int64_t len = gs[GS_RUNQ_LEN];
      for (int64_t k = 0; k < len - 1; k++) runq[k] = runq[k + 1];
      gs[GS_RUNQ_LEN] = len - 1;
      int64_t ts = J(j)[J_TSLICE_US];
      if (ts < 100) ts = 100;            // TSLICE_MIN_US
      if (ts > 1000000) ts = 1000000;    // TSLICE_MAX_US
      int64_t q_ns = ts * 1000;
      // probe.do_schedule: wait sample + dispatch count + switches.
      int64_t* s = J(j);
      int64_t wait = s[J_ENQ_SET] ? now - s[J_ENQ_TS] : 0;
      s[J_ENQ_SET] = 0;
      if (wait < 0) wait = 0;
      if (wait) s[J_WAIT_ACC] += wait;
      if (s[J_WAIT_N] >= s[J_WAIT_CAP]) {
        status = SIM_ERR_WAIT;
        gs[GS_STATUS_ARG] = j;
        break;
      }
      wt_of(j)[s[J_WAIT_N]] = now;
      ww_of(j)[s[J_WAIT_N]] = wait;
      s[J_WAIT_N]++;
      s[J_DISPATCHES]++;
      if (gs[GS_TIMELINE]) {
        int64_t q_us = q_ns / 1000;
        if (q_us != s[J_LAST_Q]) {
          if (s[J_QT_N] >= s[J_QT_CAP]) {
            status = SIM_ERR_TIMELINE;
            gs[GS_STATUS_ARG] = j;
            break;
          }
          qt_of(j)[s[J_QT_N]] = now;
          qq_of(j)[s[J_QT_N]] = q_us;
          s[J_QT_N]++;
          s[J_LAST_Q] = q_us;
        }
      }
      if (gs[GS_LAST_PICK] != j) {
        gs[GS_SWITCHES]++;
        gs[GS_LAST_PICK] = j;
      }
      if (!run_quantum(j, q_ns)) break;
    }
    // flush_counters: publish deferred RUNQ_WAIT_NS sums.
    if (status == SIM_OK) {
      for (int64_t j = 0; j < n; j++) {
        C(j)[C_RUNQ_WAIT] += (uint64_t)J(j)[J_WAIT_ACC];
        J(j)[J_WAIT_ACC] = 0;
      }
    }
    gs[GS_NOW_NS] = now;
    gs[GS_STATUS] = status;
  }
};

}  // namespace pbst_sim

extern "C" {

int64_t pbst_sim_abi() { return pbst_sim::SIM_ABI_VERSION; }
int64_t pbst_sim_gs_words() { return pbst_sim::GS_WORDS; }
int64_t pbst_sim_js_words() { return pbst_sim::JS_WORDS; }
int64_t pbst_sim_jf_words() { return pbst_sim::JF_WORDS; }
int64_t pbst_sim_ev_words() { return pbst_sim::EV_WORDS; }

// Run the sweep-mode sim core over the caller's state block. Pointer
// tables (rng/wt/ww/qt/qq) are u64 addresses of the per-job numpy
// buffers. Returns the status word (0 ok, negative = overflow/internal;
// also stored in gs[GS_STATUS], offending job in gs[GS_STATUS_ARG]).
int64_t pbst_sim_run(int64_t* gs, double* gf, int64_t* js, double* jf,
                     uint64_t* counters, uint64_t* prev,
                     const int64_t* ph_i, const double* ph_f,
                     int64_t* heap, int64_t* runq, double* window,
                     int64_t* hist, const uint64_t* rng_tab,
                     const uint64_t* wt_tab, const uint64_t* ww_tab,
                     const uint64_t* qt_tab, const uint64_t* qq_tab,
                     int64_t* ev) {
  pbst_sim::Sim sim;
  sim.gs = gs;
  sim.gf = gf;
  sim.js = js;
  sim.jf = jf;
  sim.counters = counters;
  sim.prev = prev;
  sim.ph_i = ph_i;
  sim.ph_f = ph_f;
  sim.heap = heap;
  sim.runq = runq;
  sim.window = window;
  sim.hist = hist;
  sim.rng_tab = rng_tab;
  sim.wt_tab = wt_tab;
  sim.ww_tab = ww_tab;
  sim.qt_tab = qt_tab;
  sim.qq_tab = qq_tab;
  sim.ev = ev;
  sim.n = gs[pbst_sim::GS_N_JOBS];
  sim.now = gs[pbst_sim::GS_NOW_NS];
  sim.status = pbst_sim::SIM_OK;
  sim.heapify_initial();
  sim.run();
  return sim.status;
}

}  // extern "C"
