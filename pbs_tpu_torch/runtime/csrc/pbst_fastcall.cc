// pbst_fastcall: METH_FASTCALL CPython bindings for the hot subset of
// the native runtime (pbst_runtime.cc).
//
// ctypes remains the canonical binding (runtime/native.py) — flat,
// dependency-free, loadable anywhere a .so loads. But a ctypes call
// pays its argument marshalling on every call, which is the whole
// budget of a sub-µs emit and dwarfs the C work of a batched call.
// This module wraps the SAME C entry points (compiled in, no dlopen)
// behind vectorcall functions, so the per-call overhead drops to a
// fraction of ctypes'. It needs Python.h to build; when the headers are missing
// the build fails and everything runs on the ctypes tier — behavior
// is identical either way because both tiers execute the same
// functions over the same buffer layout.
//
// Argument convention: a buffer argument is EITHER an object exposing
// the buffer protocol (a numpy array: bounds-safe, contiguity checked
// by PyBUF_SIMPLE) or a raw address int (``arr.ctypes.data``,
// precomputed once by owners of long-lived buffers — the per-access
// cost of ``.ctypes`` is itself microseconds). Counter values mask to
// u64 two's complement like the Python paths' ``& _U64_MASK``.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include "pbst_runtime.cc"

namespace {

// u64 with two's-complement masking (PyLong_AsUnsignedLongLongMask);
// -1 can be a legal masked value, so errors need PyErr_Occurred().
inline int as_u64(PyObject* o, uint64_t* out) {
  uint64_t v = PyLong_AsUnsignedLongLongMask(o);
  if (v == (uint64_t)-1 && PyErr_Occurred()) return 0;
  *out = v;
  return 1;
}

inline int as_i64(PyObject* o, int64_t* out) {
  int64_t v = PyLong_AsLongLong(o);
  if (v == -1 && PyErr_Occurred()) return 0;
  *out = v;
  return 1;
}

// A buffer argument: raw-address int or buffer-protocol object. The
// view (when taken) is held for the duration of the C call and
// released by the destructor. For buffer-protocol args the caller's
// length is known, so each entry point validates it against the size
// the C function will touch (need_words) — that is what makes the
// "bounds-safe" claim of the module docstring true; raw-address ints
// skip all checks by design (the precomputed-pointer fast path owns
// its layout).
struct ArgBuf {
  Py_buffer view;
  bool held;
  uint64_t* ptr;
  ArgBuf() : view(), held(false), ptr(nullptr) {}
  ~ArgBuf() {
    if (held) PyBuffer_Release(&view);
  }
  int take(PyObject* o, bool writable) {
    if (PyLong_Check(o)) {
      uint64_t v;
      if (!as_u64(o, &v)) return 0;
      ptr = reinterpret_cast<uint64_t*>(v);
      return 1;
    }
    if (PyObject_GetBuffer(
            o, &view, writable ? PyBUF_WRITABLE : PyBUF_SIMPLE) != 0)
      return 0;
    held = true;
    ptr = static_cast<uint64_t*>(view.buf);
    return 1;
  }
  // True when the view (if held) spans at least need_words u64 words.
  int check(int64_t need_words, const char* what) {
    if (!held || view.len >= (Py_ssize_t)(need_words * 8)) return 1;
    PyErr_Format(PyExc_ValueError,
                 "%s: buffer too small (%zd bytes < %lld words)", what,
                 view.len, (long long)need_words);
    return 0;
  }
};

// A trace-ring buffer: header must fit, then the capacity word names
// the full footprint.
inline int check_ring(ArgBuf* b) {
  if (!b->held) return 1;
  if (!b->check(kTraceHeaderWords, "ring header")) return 0;
  return b->check(
      kTraceHeaderWords + (int64_t)b->ptr[2] * kTraceRecWords, "ring");
}

PyObject* fc_trace_emit(PyObject*, PyObject* const* args,
                        Py_ssize_t nargs) {
  if (nargs < 3 || nargs > 9) {
    PyErr_SetString(PyExc_TypeError,
                    "trace_emit(ring, ts, ev, a0..a5) wants 3-9 args");
    return nullptr;
  }
  ArgBuf buf;
  uint64_t ts, ev, a[6] = {0, 0, 0, 0, 0, 0};
  if (!buf.take(args[0], true) || !check_ring(&buf) ||
      !as_u64(args[1], &ts) || !as_u64(args[2], &ev))
    return nullptr;
  for (Py_ssize_t j = 0; j + 3 < nargs && j < 6; j++) {
    if (!as_u64(args[j + 3], &a[j])) return nullptr;
  }
  int ok = pbst_trace_emit(buf.ptr, ts, ev, a[0], a[1], a[2], a[3],
                           a[4], a[5]);
  return PyBool_FromLong(ok);
}

PyObject* fc_trace_emit_many(PyObject*, PyObject* const* args,
                             Py_ssize_t nargs) {
  if (nargs != 3) {
    PyErr_SetString(PyExc_TypeError, "trace_emit_many(ring, recs, n)");
    return nullptr;
  }
  ArgBuf buf, recs;
  int64_t n;
  if (!buf.take(args[0], true) || !check_ring(&buf) ||
      !recs.take(args[1], false) || !as_i64(args[2], &n) ||
      !recs.check(n * kTraceRecWords, "recs"))
    return nullptr;
  return PyLong_FromLong(pbst_trace_emit_many(buf.ptr, recs.ptr, (int)n));
}

PyObject* fc_trace_consume(PyObject*, PyObject* const* args,
                           Py_ssize_t nargs) {
  if (nargs != 3) {
    PyErr_SetString(PyExc_TypeError,
                    "trace_consume(ring, out, max_records)");
    return nullptr;
  }
  ArgBuf buf, out;
  int64_t maxr;
  if (!buf.take(args[0], true) || !check_ring(&buf) ||
      !out.take(args[1], true) || !as_i64(args[2], &maxr) ||
      !out.check(maxr * kTraceRecWords, "out"))
    return nullptr;
  return PyLong_FromLong(pbst_trace_consume(buf.ptr, out.ptr, (int)maxr));
}

PyObject* fc_hist_record(PyObject*, PyObject* const* args,
                         Py_ssize_t nargs) {
  if (nargs != 4) {
    PyErr_SetString(PyExc_TypeError,
                    "hist_record(ledger, slot, value, shift)");
    return nullptr;
  }
  ArgBuf buf;
  uint64_t value;
  int64_t slot, shift;
  if (!buf.take(args[0], true) || !as_i64(args[1], &slot) ||
      !as_u64(args[2], &value) || !as_i64(args[3], &shift) ||
      !buf.check((slot + 1) * kSlotWords, "ledger"))
    return nullptr;
  if (slot < 0) {
    PyErr_SetString(PyExc_IndexError, "hist_record: negative slot");
    return nullptr;
  }
  pbst_hist_record(buf.ptr, slot, value, (int)shift);
  Py_RETURN_NONE;
}

PyObject* fc_hist_record_many(PyObject*, PyObject* const* args,
                              Py_ssize_t nargs) {
  if (nargs != 6) {
    PyErr_SetString(PyExc_TypeError,
                    "hist_record_many(ledger, total_slots, slots, "
                    "values, n, shift)");
    return nullptr;
  }
  ArgBuf buf, slots, values;
  int64_t total, n, shift;
  if (!buf.take(args[0], true) || !as_i64(args[1], &total) ||
      !slots.take(args[2], false) || !values.take(args[3], false) ||
      !as_i64(args[4], &n) || !as_i64(args[5], &shift) ||
      !buf.check(total * kSlotWords, "ledger") ||
      !slots.check(n, "slots") || !values.check(n, "values"))
    return nullptr;
  int rc = pbst_hist_record_many(
      buf.ptr, total, reinterpret_cast<int64_t*>(slots.ptr), values.ptr,
      (int)n, (int)shift);
  if (rc == -2) {
    PyErr_SetString(PyExc_IndexError,
                    "hist_record_many: slot out of range");
    return nullptr;
  }
  Py_RETURN_NONE;
}

PyObject* fc_ledger_snapshot_many(PyObject*, PyObject* const* args,
                                  Py_ssize_t nargs) {
  if (nargs != 6) {
    PyErr_SetString(PyExc_TypeError,
                    "ledger_snapshot_many(ledger, total_slots, slots, "
                    "n_slots, out, max_retries)");
    return nullptr;
  }
  ArgBuf buf, slots, out;
  int64_t total, n, retries;
  if (!buf.take(args[0], false) || !as_i64(args[1], &total) ||
      !slots.take(args[2], false) || !as_i64(args[3], &n) ||
      !out.take(args[4], true) || !as_i64(args[5], &retries) ||
      !buf.check(total * kSlotWords, "ledger") ||
      !slots.check(n, "slots") || !out.check(n * kNumCounters, "out"))
    return nullptr;
  int rc = pbst_ledger_snapshot_many(
      buf.ptr, total, reinterpret_cast<int64_t*>(slots.ptr), (int)n,
      out.ptr, (int)retries);
  if (rc == -2) {
    PyErr_SetString(PyExc_IndexError,
                    "ledger_snapshot_many: slot out of range");
    return nullptr;
  }
  return PyLong_FromLong(rc);
}

// pbst_sim_run's buffer arity (the prototype in pbst_runtime.cc):
// gs gf js jf counters prev ph_i ph_f heap runq window hist
// rng/wt/ww/qt/qq tabs ev.
constexpr int kSimRunArgs = 18;

PyObject* fc_sim_run(PyObject*, PyObject* const* args,
                     Py_ssize_t nargs) {
  // (gs, gf, js, jf, counters, prev, ph_i, ph_f, heap, runq, window,
  //  hist, rng_tab, wt_tab, ww_tab, qt_tab, qq_tab, ev) — the
  // pbst_sim_run state block (numpy buffers or raw addresses). One
  // call per engine run: the binding overhead is noise against
  // a whole simulated horizon, but the tier exists so the sim core
  // rides the same fastcall->ctypes->python order as every other
  // native path (and so stale-ABI detection covers it).
  if (nargs != kSimRunArgs) {
    PyErr_SetString(PyExc_TypeError,
                    "sim_run(gs, gf, js, jf, counters, prev, ph_i, "
                    "ph_f, heap, runq, window, hist, rng_tab, wt_tab, "
                    "ww_tab, qt_tab, qq_tab, ev) wants 18 buffers");
    return nullptr;
  }
  ArgBuf b[kSimRunArgs];
  // gs is writable and must at least hold the scalar block; the rest
  // are sized by the Python marshaller (sim/native_core.py) against
  // the same ABI word counts this .so exports.
  for (int i = 0; i < kSimRunArgs; i++) {
    bool writable = !(i == 6 || i == 7 || i == 12 || i == 13 ||
                      i == 14 || i == 15 || i == 16);
    if (!b[i].take(args[i], writable)) return nullptr;
  }
  if (!b[0].check(pbst_sim_gs_words(), "gs")) return nullptr;
  int64_t rc = pbst_sim_run(
      reinterpret_cast<int64_t*>(b[0].ptr),
      reinterpret_cast<double*>(b[1].ptr),
      reinterpret_cast<int64_t*>(b[2].ptr),
      reinterpret_cast<double*>(b[3].ptr), b[4].ptr, b[5].ptr,
      reinterpret_cast<const int64_t*>(b[6].ptr),
      reinterpret_cast<const double*>(b[7].ptr),
      reinterpret_cast<int64_t*>(b[8].ptr),
      reinterpret_cast<int64_t*>(b[9].ptr),
      reinterpret_cast<double*>(b[10].ptr),
      reinterpret_cast<int64_t*>(b[11].ptr), b[12].ptr, b[13].ptr,
      b[14].ptr, b[15].ptr, b[16].ptr,
      reinterpret_cast<int64_t*>(b[17].ptr));
  return PyLong_FromLongLong(rc);
}

PyObject* fc_sim_abi(PyObject*, PyObject* const*, Py_ssize_t) {
  return PyLong_FromLongLong(pbst_sim_abi());
}

PyMethodDef kMethods[] = {
    {"trace_emit", (PyCFunction)(void (*)())fc_trace_emit,
     METH_FASTCALL, "scalar ring emit: (ring, ts, ev, a0..a5) -> bool"},
    {"trace_emit_many", (PyCFunction)(void (*)())fc_trace_emit_many,
     METH_FASTCALL, "batched ring emit: (ring, recs, n) -> written"},
    {"trace_consume", (PyCFunction)(void (*)())fc_trace_consume,
     METH_FASTCALL, "ring drain: (ring, out, max_records) -> count"},
    {"hist_record", (PyCFunction)(void (*)())fc_hist_record,
     METH_FASTCALL,
     "log2 hist sample: (ledger, slot, value, shift) -> None"},
    {"hist_record_many", (PyCFunction)(void (*)())fc_hist_record_many,
     METH_FASTCALL,
     "batched samples: (ledger, total_slots, slots, values, n, shift)"},
    {"ledger_snapshot_many",
     (PyCFunction)(void (*)())fc_ledger_snapshot_many, METH_FASTCALL,
     "vector snapshot: (ledger, total_slots, slots, n_slots, out, "
     "max_retries) -> retries (IndexError on bad slot, -1 exhausted)"},
    {"sim_run", (PyCFunction)(void (*)())fc_sim_run, METH_FASTCALL,
     "sweep-mode sim dispatch core over a caller state block -> status"},
    {"sim_abi", (PyCFunction)(void (*)())fc_sim_abi, METH_FASTCALL,
     "native sim core ABI version"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "pbst_fastcall",
    "vectorcall bindings for the native runtime hot paths", -1,
    kMethods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

extern "C" PyMODINIT_FUNC PyInit_pbst_fastcall(void) {
  return PyModule_Create(&kModule);
}
