// moolib_tpu_torch native runtime, the port's copy of
// moolib_tpu/native/_native.cpp: wire serializer hot path + process-shared
// semaphores for the shared-memory lanes.
//
// Design parity with the reference's native layer (reference:
// src/serialization.h:238-379 two-pass serializer; src/shm.h:96-232
// SharedSemaphore over sem_init(pshared=1); the reference builds its whole
// runtime in C++17 — here the Python asyncio control plane keeps the state
// machines and this module owns the byte-bashing and process-shared
// synchronization primitives).
//
// The serializer implements the EXACT wire format of
// moolib_tpu_torch/rpc/serial.py (tagged union, little-endian) for the
// basic types; tensors and pickle-fallback objects round-trip through
// Python callbacks so numpy/torch handling stays in one place. Both sides are
// format-compatible and fuzz-tested against each other.
//
// Build: g++ -O2 -shared -fPIC (driven by moolib_tpu_torch/native/__init__.py).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <ctime>
#include <semaphore.h>
#include <string>

namespace {

// ---------------------------------------------------------------------------
// Wire tags (must match moolib_tpu_torch/rpc/serial.py)
// ---------------------------------------------------------------------------
enum Tag : uint8_t {
  T_NONE = 0,
  T_TRUE = 1,
  T_FALSE = 2,
  T_INT = 3,
  T_FLOAT = 4,
  T_STR = 5,
  T_BYTES = 6,
  T_LIST = 7,
  T_TUPLE = 8,
  T_DICT = 9,
  T_TENSOR = 10,
  T_PICKLED = 11,
  T_BIGINT = 12,
};

struct Writer {
  std::string buf;
  void u8(uint8_t v) { buf.push_back(static_cast<char>(v)); }
  void raw(const void* p, size_t n) {
    buf.append(static_cast<const char*>(p), n);
  }
  template <typename T>
  void num(T v) {
    raw(&v, sizeof(T));  // little-endian hosts only (x86-64/arm64)
  }
};

// u32 length/count fields must not silently truncate (the pure-Python
// encoder's struct.pack('<I') raises on overflow — match it).
bool check_u32(Py_ssize_t n) {
  if (static_cast<uint64_t>(n) > UINT32_MAX) {
    PyErr_Format(PyExc_OverflowError,
                 "wire u32 field overflow: %zd", n);
    return false;
  }
  return true;
}

// Encode obj into w; non-basic objects go through `fallback(obj)`, which
// must return bytes (the already-encoded metadata chunk for that object —
// it may also append to the shared tensor list it closed over).
int encode(PyObject* obj, Writer& w, PyObject* fallback);

int encode_guarded(PyObject* obj, Writer& w, PyObject* fallback) {
  // Depth guard: cyclic/deep structures raise RecursionError instead of
  // overflowing the C stack.
  if (Py_EnterRecursiveCall(" while encoding a moolib_tpu message"))
    return -1;
  int rc = encode(obj, w, fallback);
  Py_LeaveRecursiveCall();
  return rc;
}

int encode(PyObject* obj, Writer& w, PyObject* fallback) {
  if (obj == Py_None) {
    w.u8(T_NONE);
    return 0;
  }
  if (obj == Py_True) {
    w.u8(T_TRUE);
    return 0;
  }
  if (obj == Py_False) {
    w.u8(T_FALSE);
    return 0;
  }
  if (PyLong_CheckExact(obj)) {
    int overflow = 0;
    long long v = PyLong_AsLongLongAndOverflow(obj, &overflow);
    if (!overflow) {
      if (v == -1 && PyErr_Occurred()) return -1;
      w.u8(T_INT);
      w.num<int64_t>(v);
      return 0;
    }
    PyObject* s = PyObject_Str(obj);
    if (!s) return -1;
    Py_ssize_t n;
    const char* p = PyUnicode_AsUTF8AndSize(s, &n);
    if (!p) {
      Py_DECREF(s);
      return -1;
    }
    if (!check_u32(n)) {
      Py_DECREF(s);
      return -1;
    }
    w.u8(T_BIGINT);
    w.num<uint32_t>(static_cast<uint32_t>(n));
    w.raw(p, static_cast<size_t>(n));
    Py_DECREF(s);
    return 0;
  }
  if (PyFloat_CheckExact(obj)) {
    w.u8(T_FLOAT);
    w.num<double>(PyFloat_AS_DOUBLE(obj));
    return 0;
  }
  if (PyUnicode_CheckExact(obj)) {
    Py_ssize_t n;
    const char* p = PyUnicode_AsUTF8AndSize(obj, &n);
    if (!p) return -1;
    if (!check_u32(n)) return -1;
    w.u8(T_STR);
    w.num<uint32_t>(static_cast<uint32_t>(n));
    w.raw(p, static_cast<size_t>(n));
    return 0;
  }
  if (PyBytes_CheckExact(obj)) {
    w.u8(T_BYTES);
    w.num<uint64_t>(static_cast<uint64_t>(PyBytes_GET_SIZE(obj)));
    w.raw(PyBytes_AS_STRING(obj), static_cast<size_t>(PyBytes_GET_SIZE(obj)));
    return 0;
  }
  if (PyByteArray_CheckExact(obj) || PyMemoryView_Check(obj)) {
    Py_buffer view;
    if (PyObject_GetBuffer(obj, &view, PyBUF_CONTIG_RO) < 0) return -1;
    w.u8(T_BYTES);
    w.num<uint64_t>(static_cast<uint64_t>(view.len));
    w.raw(view.buf, static_cast<size_t>(view.len));
    PyBuffer_Release(&view);
    return 0;
  }
  if (PyList_CheckExact(obj)) {
    Py_ssize_t n = PyList_GET_SIZE(obj);
    if (!check_u32(n)) return -1;
    w.u8(T_LIST);
    w.num<uint32_t>(static_cast<uint32_t>(n));
    for (Py_ssize_t i = 0; i < n; i++) {
      if (encode_guarded(PyList_GET_ITEM(obj, i), w, fallback) < 0) return -1;
    }
    return 0;
  }
  if (PyTuple_CheckExact(obj)) {
    Py_ssize_t n = PyTuple_GET_SIZE(obj);
    if (!check_u32(n)) return -1;
    w.u8(T_TUPLE);
    w.num<uint32_t>(static_cast<uint32_t>(n));
    for (Py_ssize_t i = 0; i < n; i++) {
      if (encode_guarded(PyTuple_GET_ITEM(obj, i), w, fallback) < 0)
        return -1;
    }
    return 0;
  }
  if (PyDict_CheckExact(obj)) {
    if (!check_u32(PyDict_GET_SIZE(obj))) return -1;
    w.u8(T_DICT);
    w.num<uint32_t>(static_cast<uint32_t>(PyDict_GET_SIZE(obj)));
    PyObject *key, *value;
    Py_ssize_t pos = 0;
    while (PyDict_Next(obj, &pos, &key, &value)) {
      if (encode_guarded(key, w, fallback) < 0) return -1;
      if (encode_guarded(value, w, fallback) < 0) return -1;
    }
    return 0;
  }
  // Tensors / arbitrary objects: Python-side handler appends the encoded
  // chunk (and registers tensor payloads in its closure's list).
  PyObject* chunk = PyObject_CallFunctionObjArgs(fallback, obj, nullptr);
  if (!chunk) return -1;
  char* p;
  Py_ssize_t n;
  if (PyBytes_AsStringAndSize(chunk, &p, &n) < 0) {
    Py_DECREF(chunk);
    return -1;
  }
  w.raw(p, static_cast<size_t>(n));
  Py_DECREF(chunk);
  return 0;
}

PyObject* py_encode(PyObject*, PyObject* args) {
  PyObject* obj;
  PyObject* fallback;
  if (!PyArg_ParseTuple(args, "OO", &obj, &fallback)) return nullptr;
  Writer w;
  w.buf.reserve(256);
  if (encode(obj, w, fallback) < 0) return nullptr;
  return PyBytes_FromStringAndSize(w.buf.data(),
                                   static_cast<Py_ssize_t>(w.buf.size()));
}

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------
struct ReaderState {
  const uint8_t* buf;
  size_t len;
  size_t pos;
  bool take(size_t n, const uint8_t** out) {
    if (pos + n > len) return false;
    *out = buf + pos;
    pos += n;
    return true;
  }
  template <typename T>
  bool num(T* out) {
    const uint8_t* p;
    if (!take(sizeof(T), &p)) return false;
    std::memcpy(out, p, sizeof(T));
    return true;
  }
};

PyObject* truncated() {
  PyErr_SetString(PyExc_ValueError, "truncated message");
  return nullptr;
}

PyObject* decode(ReaderState& r, PyObject* fallback);

PyObject* decode_guarded(ReaderState& r, PyObject* fallback) {
  // Depth guard: network-controlled nesting must raise, not smash the stack.
  if (Py_EnterRecursiveCall(" while decoding a moolib_tpu message"))
    return nullptr;
  PyObject* out = decode(r, fallback);
  Py_LeaveRecursiveCall();
  return out;
}

// fallback(tag, pos) -> (obj, new_pos): Python side decodes TENSOR/PICKLED
// starting at `pos` inside the full meta buffer it holds.
PyObject* decode(ReaderState& r, PyObject* fallback) {
  const uint8_t* p;
  if (!r.take(1, &p)) return truncated();
  switch (*p) {
    case T_NONE:
      Py_RETURN_NONE;
    case T_TRUE:
      Py_RETURN_TRUE;
    case T_FALSE:
      Py_RETURN_FALSE;
    case T_INT: {
      int64_t v;
      if (!r.num(&v)) return truncated();
      return PyLong_FromLongLong(v);
    }
    case T_FLOAT: {
      double v;
      if (!r.num(&v)) return truncated();
      return PyFloat_FromDouble(v);
    }
    case T_STR: {
      uint32_t n;
      if (!r.num(&n)) return truncated();
      const uint8_t* s;
      if (!r.take(n, &s)) return truncated();
      return PyUnicode_DecodeUTF8(reinterpret_cast<const char*>(s), n,
                                  nullptr);
    }
    case T_BYTES: {
      uint64_t n;
      if (!r.num(&n)) return truncated();
      const uint8_t* s;
      if (!r.take(static_cast<size_t>(n), &s)) return truncated();
      return PyBytes_FromStringAndSize(reinterpret_cast<const char*>(s),
                                       static_cast<Py_ssize_t>(n));
    }
    case T_BIGINT: {
      uint32_t n;
      if (!r.num(&n)) return truncated();
      const uint8_t* s;
      if (!r.take(n, &s)) return truncated();
      PyObject* str = PyUnicode_DecodeUTF8(
          reinterpret_cast<const char*>(s), n, nullptr);
      if (!str) return nullptr;
      PyObject* out = PyLong_FromUnicodeObject(str, 10);
      Py_DECREF(str);
      return out;
    }
    case T_LIST: {
      uint32_t n;
      if (!r.num(&n)) return truncated();
      PyObject* lst = PyList_New(n);
      if (!lst) return nullptr;
      for (uint32_t i = 0; i < n; i++) {
        PyObject* item = decode_guarded(r, fallback);
        if (!item) {
          Py_DECREF(lst);
          return nullptr;
        }
        PyList_SET_ITEM(lst, i, item);
      }
      return lst;
    }
    case T_TUPLE: {
      uint32_t n;
      if (!r.num(&n)) return truncated();
      PyObject* tup = PyTuple_New(n);
      if (!tup) return nullptr;
      for (uint32_t i = 0; i < n; i++) {
        PyObject* item = decode_guarded(r, fallback);
        if (!item) {
          Py_DECREF(tup);
          return nullptr;
        }
        PyTuple_SET_ITEM(tup, i, item);
      }
      return tup;
    }
    case T_DICT: {
      uint32_t n;
      if (!r.num(&n)) return truncated();
      // PyDict_New over the private _PyDict_NewPresized: the presize was a
      // micro-optimization, but the private API is gone on CPython 3.13+.
      PyObject* d = PyDict_New();
      if (!d) return nullptr;
      for (uint32_t i = 0; i < n; i++) {
        PyObject* k = decode_guarded(r, fallback);
        if (!k) {
          Py_DECREF(d);
          return nullptr;
        }
        PyObject* v = decode_guarded(r, fallback);
        if (!v) {
          Py_DECREF(k);
          Py_DECREF(d);
          return nullptr;
        }
        if (PyDict_SetItem(d, k, v) < 0) {
          Py_DECREF(k);
          Py_DECREF(v);
          Py_DECREF(d);
          return nullptr;
        }
        Py_DECREF(k);
        Py_DECREF(v);
      }
      return d;
    }
    case T_TENSOR:
    case T_PICKLED: {
      // Rewind past the tag: the Python fallback re-reads it.
      PyObject* res = PyObject_CallFunction(
          fallback, "in", static_cast<int>(*p),
          static_cast<Py_ssize_t>(r.pos));
      if (!res) return nullptr;
      PyObject* obj;
      Py_ssize_t newpos;
      if (!PyArg_ParseTuple(res, "On", &obj, &newpos)) {
        Py_DECREF(res);
        return nullptr;
      }
      Py_INCREF(obj);
      Py_DECREF(res);
      r.pos = static_cast<size_t>(newpos);
      return obj;
    }
    default:
      PyErr_Format(PyExc_ValueError, "unknown wire tag %d",
                   static_cast<int>(*p));
      return nullptr;
  }
}

PyObject* py_decode(PyObject*, PyObject* args) {
  Py_buffer view;
  PyObject* fallback;
  if (!PyArg_ParseTuple(args, "y*O", &view, &fallback)) return nullptr;
  ReaderState r{static_cast<const uint8_t*>(view.buf),
                static_cast<size_t>(view.len), 0};
  PyObject* out = decode(r, fallback);
  size_t end = r.pos;
  PyBuffer_Release(&view);
  if (!out) return nullptr;
  PyObject* res = Py_BuildValue("Nn", out, static_cast<Py_ssize_t>(end));
  return res;
}

// ---------------------------------------------------------------------------
// Process-shared semaphores inside caller-provided shared memory
// (reference: SharedSemaphore, src/shm.h:96-232)
// ---------------------------------------------------------------------------

sem_t* sem_at(Py_buffer* view, Py_ssize_t offset) {
  if (offset < 0 ||
      offset + static_cast<Py_ssize_t>(sizeof(sem_t)) > view->len) {
    PyErr_SetString(PyExc_ValueError, "semaphore offset out of range");
    return nullptr;
  }
  return reinterpret_cast<sem_t*>(static_cast<char*>(view->buf) + offset);
}

PyObject* py_sem_size(PyObject*, PyObject*) {
  return PyLong_FromSize_t(sizeof(sem_t));
}

PyObject* py_sem_init(PyObject*, PyObject* args) {
  Py_buffer view;
  Py_ssize_t offset;
  if (!PyArg_ParseTuple(args, "w*n", &view, &offset)) return nullptr;
  sem_t* s = sem_at(&view, offset);
  int rc = s ? sem_init(s, /*pshared=*/1, 0) : -1;
  PyBuffer_Release(&view);
  if (!s) return nullptr;
  if (rc != 0) return PyErr_SetFromErrno(PyExc_OSError);
  Py_RETURN_NONE;
}

PyObject* py_sem_post(PyObject*, PyObject* args) {
  Py_buffer view;
  Py_ssize_t offset;
  if (!PyArg_ParseTuple(args, "w*n", &view, &offset)) return nullptr;
  sem_t* s = sem_at(&view, offset);
  int rc = s ? sem_post(s) : -1;
  PyBuffer_Release(&view);
  if (!s) return nullptr;
  if (rc != 0) return PyErr_SetFromErrno(PyExc_OSError);
  Py_RETURN_NONE;
}

PyObject* py_sem_wait(PyObject*, PyObject* args) {
  Py_buffer view;
  Py_ssize_t offset;
  double timeout = -1.0;  // < 0: wait forever
  if (!PyArg_ParseTuple(args, "w*n|d", &view, &offset, &timeout))
    return nullptr;
  sem_t* s = sem_at(&view, offset);
  if (!s) {
    PyBuffer_Release(&view);
    return nullptr;
  }
  int rc;
  if (timeout < 0) {
    Py_BEGIN_ALLOW_THREADS;
    do {
      rc = sem_wait(s);
    } while (rc != 0 && errno == EINTR);
    Py_END_ALLOW_THREADS;
  } else {
    struct timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    long nsec = ts.tv_nsec + static_cast<long>(
        (timeout - static_cast<long>(timeout)) * 1e9);
    ts.tv_sec += static_cast<time_t>(timeout) + nsec / 1000000000L;
    ts.tv_nsec = nsec % 1000000000L;
    Py_BEGIN_ALLOW_THREADS;
    do {
      rc = sem_timedwait(s, &ts);
    } while (rc != 0 && errno == EINTR);
    Py_END_ALLOW_THREADS;
  }
  PyBuffer_Release(&view);
  if (rc == 0) Py_RETURN_TRUE;
  if (errno == ETIMEDOUT) Py_RETURN_FALSE;
  return PyErr_SetFromErrno(PyExc_OSError);
}

PyObject* py_sem_trywait(PyObject*, PyObject* args) {
  Py_buffer view;
  Py_ssize_t offset;
  if (!PyArg_ParseTuple(args, "w*n", &view, &offset)) return nullptr;
  sem_t* s = sem_at(&view, offset);
  if (!s) {
    PyBuffer_Release(&view);
    return nullptr;
  }
  int rc = sem_trywait(s);
  PyBuffer_Release(&view);
  if (rc == 0) Py_RETURN_TRUE;
  if (errno == EAGAIN) Py_RETURN_FALSE;
  return PyErr_SetFromErrno(PyExc_OSError);
}

PyObject* py_sem_destroy(PyObject*, PyObject* args) {
  Py_buffer view;
  Py_ssize_t offset;
  if (!PyArg_ParseTuple(args, "w*n", &view, &offset)) return nullptr;
  sem_t* s = sem_at(&view, offset);
  int rc = s ? sem_destroy(s) : -1;
  PyBuffer_Release(&view);
  if (!s) return nullptr;
  if (rc != 0) return PyErr_SetFromErrno(PyExc_OSError);
  Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"encode", py_encode, METH_VARARGS,
     "encode(obj, fallback) -> bytes: wire-format metadata"},
    {"decode", py_decode, METH_VARARGS,
     "decode(buf, fallback) -> (obj, end_pos)"},
    {"sem_size", py_sem_size, METH_NOARGS, "sizeof(sem_t)"},
    {"sem_init", py_sem_init, METH_VARARGS, "init pshared sem at offset"},
    {"sem_post", py_sem_post, METH_VARARGS, "post sem at offset"},
    {"sem_wait", py_sem_wait, METH_VARARGS,
     "wait sem at offset (timeout seconds; <0 = forever) -> bool"},
    {"sem_trywait", py_sem_trywait, METH_VARARGS, "trywait -> bool"},
    {"sem_destroy", py_sem_destroy, METH_VARARGS, "destroy sem at offset"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_native",
    "moolib_tpu_torch native runtime (serializer + shared-memory semaphores)",
    -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__native(void) { return PyModule_Create(&moduledef); }
