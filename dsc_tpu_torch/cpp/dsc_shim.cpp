// dsc_tpu_torch C ABI shim — embeds CPython and forwards every call to
// dsc_tpu_torch.capi (the Python half of the front door).
//
// The reference stack is Python -> ctypes -> C++ core (_bindings.py:31-35);
// this one inverts it: C/C++ -> embedded Python -> PyTorch/CUDA.
// Both front-ends share one runtime. All Python access is GIL-guarded so
// the ABI is callable from any thread.
//
// It implements cpp/include/dsc.h unchanged and differs from
// cpp/src/dsc_shim.cpp only in the module it imports; build it, and the
// harness cpp/tests/test_filterfft.cpp against it, with
// `python3 -m dsc_tpu_torch.cpp.build` (build.py beside this file).

#include "dsc.h"

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>

namespace {

std::once_flag g_init_once;
PyObject *g_capi = nullptr;  // dsc_tpu_torch.capi module
std::string g_last_error;
std::mutex g_err_mutex;

void set_error(const std::string &msg) {
    std::lock_guard<std::mutex> lock(g_err_mutex);
    g_last_error = msg;
}

void capture_py_error() {
    PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
    PyErr_Fetch(&type, &value, &tb);
    std::string msg = "python error";
    if (value) {
        PyObject *s = PyObject_Str(value);
        if (s) {
            msg = PyUnicode_AsUTF8(s);
            Py_DECREF(s);
        }
    }
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
    set_error(msg);
}

void ensure_python() {
    std::call_once(g_init_once, [] {
        if (!Py_IsInitialized()) {
            Py_InitializeEx(0);
        }
        PyGILState_STATE gil = PyGILState_Ensure();
        PyObject *mod = PyImport_ImportModule("dsc_tpu_torch.capi");
        if (!mod) {
            capture_py_error();
            std::fprintf(stderr, "dsc: failed to import dsc_tpu_torch.capi: %s\n",
                         g_last_error.c_str());
        }
        g_capi = mod;
        PyGILState_Release(gil);
    });
}

// RAII GIL holder
struct Gil {
    PyGILState_STATE state;
    Gil() { state = PyGILState_Ensure(); }
    ~Gil() { PyGILState_Release(state); }
};

PyObject *int_tuple(int n, const int *vals) {
    PyObject *t = PyTuple_New(n);
    for (int i = 0; i < n; ++i)
        PyTuple_SET_ITEM(t, i, PyLong_FromLong(vals[i]));
    return t;
}

// Call capi.<name>(...) with a prebuilt args tuple; returns new ref or null.
PyObject *call(const char *name, PyObject *args) {
    if (!g_capi) {
        set_error("dsc_tpu_torch.capi not loaded");
        Py_XDECREF(args);
        return nullptr;
    }
    PyObject *fn = PyObject_GetAttrString(g_capi, name);
    if (!fn) {
        capture_py_error();
        Py_XDECREF(args);
        return nullptr;
    }
    PyObject *res = PyObject_CallObject(fn, args);
    Py_DECREF(fn);
    Py_XDECREF(args);
    if (!res) capture_py_error();
    return res;
}

dsc_tensor_h call_handle(const char *name, PyObject *args) {
    ensure_python();
    Gil gil;
    PyObject *res = call(name, args);
    if (!res) return DSC_INVALID;
    dsc_tensor_h h = (dsc_tensor_h) PyLong_AsLongLong(res);
    Py_DECREF(res);
    return h;
}

int call_void(const char *name, PyObject *args) {
    ensure_python();
    Gil gil;
    PyObject *res = call(name, args);
    if (!res) return -1;
    Py_DECREF(res);
    return 0;
}

size_t dtype_size(dsc_dtype dt) {
    switch (dt) {
        case DSC_F32: return 4;
        case DSC_F64: return 8;
        case DSC_C32: return 8;
        case DSC_C64: return 16;
    }
    return 0;
}

}  // namespace

extern "C" {

int dsc_ctx_init(size_t main_mem, size_t scratch_mem) {
    ensure_python();
    Gil gil;
    PyObject *res = call("ctx_init", Py_BuildValue("(KK)",
                         (unsigned long long) main_mem,
                         (unsigned long long) scratch_mem));
    if (!res) return -1;
    long rc = PyLong_AsLong(res);
    Py_DECREF(res);
    return (int) rc;
}

void dsc_ctx_clear(void) { call_void("ctx_clear", nullptr); }

size_t dsc_used_mem(void) {
    ensure_python();
    Gil gil;
    PyObject *res = call("used_mem", nullptr);
    if (!res) return 0;
    size_t v = (size_t) PyLong_AsUnsignedLongLong(res);
    Py_DECREF(res);
    return v;
}

void dsc_tensor_free(dsc_tensor_h h) {
    call_void("tensor_free", Py_BuildValue("(L)", (long long) h));
}

int dsc_last_error(char *buf, size_t buf_size) {
    std::lock_guard<std::mutex> lock(g_err_mutex);
    if (!buf || buf_size == 0) return (int) g_last_error.size();
    std::snprintf(buf, buf_size, "%s", g_last_error.c_str());
    return (int) g_last_error.size();
}

dsc_tensor_h dsc_tensor_from_buffer(const void *data, dsc_dtype dtype,
                                    int n_dim, const int *shape) {
    size_t ne = 1;
    for (int i = 0; i < n_dim; ++i) ne *= (size_t) shape[i];
    ensure_python();
    Gil gil;
    PyObject *bytes = PyBytes_FromStringAndSize(
        (const char *) data, (Py_ssize_t)(ne * dtype_size(dtype)));
    PyObject *args = PyTuple_New(3);
    PyTuple_SET_ITEM(args, 0, bytes);
    PyTuple_SET_ITEM(args, 1, PyLong_FromLong((long) dtype));
    PyTuple_SET_ITEM(args, 2, int_tuple(n_dim, shape));
    PyObject *res = call("tensor_from_buffer", args);
    if (!res) return DSC_INVALID;
    dsc_tensor_h h = (dsc_tensor_h) PyLong_AsLongLong(res);
    Py_DECREF(res);
    return h;
}

int dsc_tensor_to_buffer(dsc_tensor_h h, void *out, size_t out_size) {
    ensure_python();
    Gil gil;
    PyObject *res = call("tensor_to_buffer", Py_BuildValue("(L)", (long long) h));
    if (!res) return -1;
    char *buf = nullptr;
    Py_ssize_t len = 0;
    if (PyBytes_AsStringAndSize(res, &buf, &len) != 0 ||
        (size_t) len > out_size) {
        Py_DECREF(res);
        set_error("output buffer too small");
        return -1;
    }
    std::memcpy(out, buf, (size_t) len);
    Py_DECREF(res);
    return (int) len;
}

int dsc_tensor_ndim(dsc_tensor_h h) {
    ensure_python();
    Gil gil;
    PyObject *res = call("tensor_shape", Py_BuildValue("(L)", (long long) h));
    if (!res) return -1;
    int n = (int) PyTuple_GET_SIZE(res);
    Py_DECREF(res);
    return n;
}

int dsc_tensor_shape(dsc_tensor_h h, int *shape_out) {
    ensure_python();
    Gil gil;
    PyObject *res = call("tensor_shape", Py_BuildValue("(L)", (long long) h));
    if (!res) return -1;
    int n = (int) PyTuple_GET_SIZE(res);
    for (int i = 0; i < n && i < DSC_MAX_DIMS; ++i)
        shape_out[i] = (int) PyLong_AsLong(PyTuple_GET_ITEM(res, i));
    Py_DECREF(res);
    return n;
}

dsc_dtype dsc_tensor_dtype(dsc_tensor_h h) {
    ensure_python();
    Gil gil;
    PyObject *res = call("tensor_dtype", Py_BuildValue("(L)", (long long) h));
    if (!res) return DSC_F32;
    dsc_dtype dt = (dsc_dtype) PyLong_AsLong(res);
    Py_DECREF(res);
    return dt;
}

int64_t dsc_tensor_ne(dsc_tensor_h h) {
    int shape[DSC_MAX_DIMS];
    int n = dsc_tensor_shape(h, shape);
    if (n < 0) return -1;
    int64_t ne = 1;
    for (int i = 0; i < n; ++i) ne *= shape[i];
    return ne;
}

size_t dsc_tensor_nbytes(dsc_tensor_h h) {
    int64_t ne = dsc_tensor_ne(h);
    if (ne < 0) return 0;
    return (size_t) ne * dtype_size(dsc_tensor_dtype(h));
}

dsc_tensor_h dsc_wrap(double re, double im, dsc_dtype dtype) {
    return call_handle("wrap_scalar",
                       Py_BuildValue("(ddi)", re, im, (int) dtype));
}

dsc_tensor_h dsc_arange(int n, dsc_dtype dtype) {
    return call_handle("arange", Py_BuildValue("(ii)", n, (int) dtype));
}

dsc_tensor_h dsc_randn(int n_dim, const int *shape, dsc_dtype dtype) {
    ensure_python();
    Gil gil;
    PyObject *args = PyTuple_New(2);
    PyTuple_SET_ITEM(args, 0, int_tuple(n_dim, shape));
    PyTuple_SET_ITEM(args, 1, PyLong_FromLong((long) dtype));
    PyObject *res = call("randn", args);
    if (!res) return DSC_INVALID;
    dsc_tensor_h h = (dsc_tensor_h) PyLong_AsLongLong(res);
    Py_DECREF(res);
    return h;
}

dsc_tensor_h dsc_full(int n_dim, const int *shape, double re, double im,
                      dsc_dtype dtype) {
    ensure_python();
    Gil gil;
    PyObject *args = PyTuple_New(4);
    PyTuple_SET_ITEM(args, 0, int_tuple(n_dim, shape));
    PyTuple_SET_ITEM(args, 1, PyFloat_FromDouble(re));
    PyTuple_SET_ITEM(args, 2, PyFloat_FromDouble(im));
    PyTuple_SET_ITEM(args, 3, PyLong_FromLong((long) dtype));
    PyObject *res = call("full", args);
    if (!res) return DSC_INVALID;
    dsc_tensor_h h = (dsc_tensor_h) PyLong_AsLongLong(res);
    Py_DECREF(res);
    return h;
}

#define DSC_BINARY(NAME)                                                     \
    dsc_tensor_h dsc_##NAME(dsc_tensor_h a, dsc_tensor_h b) {                \
        return call_handle("binary_op", Py_BuildValue("(sLL)", #NAME,        \
                           (long long) a, (long long) b));                   \
    }                                                                        \
    dsc_tensor_h dsc_##NAME##_scalar(dsc_tensor_h a, double re, double im,   \
                                     int is_complex, int reflected) {        \
        return call_handle("binary_scalar", Py_BuildValue("(sLddii)", #NAME, \
                           (long long) a, re, im, is_complex, reflected));   \
    }

DSC_BINARY(add)
DSC_BINARY(sub)
DSC_BINARY(mul)
DSC_BINARY(div)
DSC_BINARY(pow)
#undef DSC_BINARY

#define DSC_UNARY(NAME, PYNAME)                                       \
    dsc_tensor_h dsc_##NAME(dsc_tensor_h h) {                         \
        return call_handle("unary_op",                                \
                           Py_BuildValue("(sL)", PYNAME, (long long) h)); \
    }

DSC_UNARY(cos, "cos")
DSC_UNARY(sin, "sin")
DSC_UNARY(sinc, "sinc")
DSC_UNARY(logn, "logn")
DSC_UNARY(log2, "log2")
DSC_UNARY(log10, "log10")
DSC_UNARY(exp, "exp")
DSC_UNARY(sqrt, "sqrt")
DSC_UNARY(abs, "abs")
DSC_UNARY(angle, "angle")
DSC_UNARY(conj, "conj")
DSC_UNARY(real, "real")
DSC_UNARY(imag, "imag")
DSC_UNARY(i0, "i0")
#undef DSC_UNARY

dsc_tensor_h dsc_clip(dsc_tensor_h h, double lo, double hi,
                      int has_lo, int has_hi) {
    return call_handle("clip", Py_BuildValue("(Lddii)", (long long) h, lo, hi,
                                             has_lo, has_hi));
}

#define DSC_REDUCE(NAME)                                                 \
    dsc_tensor_h dsc_##NAME(dsc_tensor_h h, int axis, int keepdims) {    \
        return call_handle("reduce_op", Py_BuildValue("(sLii)", #NAME,   \
                           (long long) h, axis, keepdims));              \
    }

DSC_REDUCE(sum)
DSC_REDUCE(mean)
DSC_REDUCE(max)
DSC_REDUCE(min)
#undef DSC_REDUCE

dsc_tensor_h dsc_reshape(dsc_tensor_h h, int n_dim, const int *shape) {
    ensure_python();
    Gil gil;
    PyObject *args = PyTuple_New(2);
    PyTuple_SET_ITEM(args, 0, PyLong_FromLongLong(h));
    PyTuple_SET_ITEM(args, 1, int_tuple(n_dim, shape));
    PyObject *res = call("reshape", args);
    if (!res) return DSC_INVALID;
    dsc_tensor_h out = (dsc_tensor_h) PyLong_AsLongLong(res);
    Py_DECREF(res);
    return out;
}

dsc_tensor_h dsc_transpose(dsc_tensor_h h, int n_axes, const int *axes) {
    ensure_python();
    Gil gil;
    PyObject *args = PyTuple_New(2);
    PyTuple_SET_ITEM(args, 0, PyLong_FromLongLong(h));
    PyTuple_SET_ITEM(args, 1, int_tuple(n_axes, axes));
    PyObject *res = call("transpose", args);
    if (!res) return DSC_INVALID;
    dsc_tensor_h out = (dsc_tensor_h) PyLong_AsLongLong(res);
    Py_DECREF(res);
    return out;
}

dsc_tensor_h dsc_concat(int n, const dsc_tensor_h *hs, int axis, int flatten) {
    ensure_python();
    Gil gil;
    PyObject *handles = PyTuple_New(n);
    for (int i = 0; i < n; ++i)
        PyTuple_SET_ITEM(handles, i, PyLong_FromLongLong(hs[i]));
    PyObject *args = PyTuple_New(3);
    PyTuple_SET_ITEM(args, 0, handles);
    PyTuple_SET_ITEM(args, 1, PyLong_FromLong(axis));
    PyTuple_SET_ITEM(args, 2, PyLong_FromLong(flatten));
    PyObject *res = call("concat", args);
    if (!res) return DSC_INVALID;
    dsc_tensor_h out = (dsc_tensor_h) PyLong_AsLongLong(res);
    Py_DECREF(res);
    return out;
}

dsc_tensor_h dsc_cast(dsc_tensor_h h, dsc_dtype dtype) {
    return call_handle("cast",
                       Py_BuildValue("(Li)", (long long) h, (int) dtype));
}

dsc_tensor_h dsc_get_slice(dsc_tensor_h h, int n, const int *starts,
                           const int *stops, const int *steps,
                           const int *is_index) {
    ensure_python();
    Gil gil;
    PyObject *args = PyTuple_New(5);
    PyTuple_SET_ITEM(args, 0, PyLong_FromLongLong(h));
    PyTuple_SET_ITEM(args, 1, int_tuple(n, starts));
    PyTuple_SET_ITEM(args, 2, int_tuple(n, stops));
    PyTuple_SET_ITEM(args, 3, int_tuple(n, steps));
    PyTuple_SET_ITEM(args, 4, int_tuple(n, is_index));
    PyObject *res = call("get_slice", args);
    if (!res) return DSC_INVALID;
    dsc_tensor_h out = (dsc_tensor_h) PyLong_AsLongLong(res);
    Py_DECREF(res);
    return out;
}

int dsc_set_slice(dsc_tensor_h h, dsc_tensor_h val, int n, const int *starts,
                  const int *stops, const int *steps, const int *is_index) {
    ensure_python();
    Gil gil;
    PyObject *args = PyTuple_New(6);
    PyTuple_SET_ITEM(args, 0, PyLong_FromLongLong(h));
    PyTuple_SET_ITEM(args, 1, PyLong_FromLongLong(val));
    PyTuple_SET_ITEM(args, 2, int_tuple(n, starts));
    PyTuple_SET_ITEM(args, 3, int_tuple(n, stops));
    PyTuple_SET_ITEM(args, 4, int_tuple(n, steps));
    PyTuple_SET_ITEM(args, 5, int_tuple(n, is_index));
    PyObject *res = call("set_slice", args);
    if (!res) return -1;
    Py_DECREF(res);
    return 0;
}

void dsc_plan_fft(int n, dsc_dtype dtype) {
    call_void("plan_fft", Py_BuildValue("(ii)", n, (int) dtype));
}

#define DSC_FFT(NAME)                                                  \
    dsc_tensor_h dsc_##NAME(dsc_tensor_h h, int n, int axis) {         \
        return call_handle("fft_op", Py_BuildValue("(sLii)", #NAME,    \
                           (long long) h, n, axis));                   \
    }

DSC_FFT(fft)
DSC_FFT(ifft)
DSC_FFT(rfft)
DSC_FFT(irfft)
#undef DSC_FFT

#define DSC_FFT2(NAME)                                                     \
    dsc_tensor_h dsc_##NAME(dsc_tensor_h h, int n0, int n1, int ax0,       \
                            int ax1) {                                     \
        return call_handle("fft2_op", Py_BuildValue("(sLiiii)", #NAME,     \
                           (long long) h, n0, n1, ax0, ax1));              \
    }

DSC_FFT2(fft2)
DSC_FFT2(ifft2)
DSC_FFT2(rfft2)
DSC_FFT2(irfft2)
#undef DSC_FFT2

dsc_tensor_h dsc_window(const char *kind, int n, double beta,
                        dsc_dtype dtype) {
    return call_handle("window",
                       Py_BuildValue("(sidi)", kind, n, beta, (int) dtype));
}

dsc_tensor_h dsc_fftfreq(int n, double d, dsc_dtype dtype) {
    return call_handle("fftfreq", Py_BuildValue("(idi)", n, d, (int) dtype));
}

dsc_tensor_h dsc_rfftfreq(int n, double d, dsc_dtype dtype) {
    return call_handle("rfftfreq", Py_BuildValue("(idi)", n, d, (int) dtype));
}

void dsc_traces_record(int record) {
    call_void("traces_record", Py_BuildValue("(i)", record));
}

void dsc_dump_traces(const char *path) {
    call_void("dump_traces", Py_BuildValue("(s)", path));
}

void dsc_clear_traces(void) { call_void("clear_traces", nullptr); }

}  // extern "C"
