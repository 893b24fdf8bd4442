// Canonical Fr words of a prover's assignment, packed from Python ints.
//
// The prover uploads its assignment, about 2^20 Python ints, as an (8, N)
// int32 array: word k of column i holds bits 32k..32k+31 of value i mod r.
// Both entry points walk a list's int objects once, with the interpreter
// lock held (load them through ctypes.PyDLL).  An exact int in [0, r) is
// read from its digits; any other element takes Python's int(v) % r through
// the C API, in the same loop.
//
// Without Python's headers this file compiles to nothing, and the callers in
// native/__init__.py keep their pure-Python paths.

#if defined(__has_include)
#if __has_include(<Python.h>)
#define PM_HAVE_PYTHON_H 1
#endif
#endif

#ifdef PM_HAVE_PYTHON_H

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>

namespace {

// BLS12-381's scalar field modulus r, little-endian 64-bit words.
const uint64_t R64[4] = {0xffffffff00000001ULL, 0x53bda402fffe5bfeULL,
                         0x3339d80809a1d805ULL, 0x73eda753299d7d48ULL};

// v's value as four little-endian 64-bit words if v is an exact int in
// [0, r); false for anything else (a subclass, a negative, a value >= r).
inline bool canonical_words(PyObject* v, uint64_t w[4]) {
    if (!PyLong_CheckExact(v)) return false;
    const PyLongObject* x = reinterpret_cast<const PyLongObject*>(v);
#if PY_VERSION_HEX >= 0x030C0000
    const uintptr_t tag = x->long_value.lv_tag;
    if ((tag & 3) == 2) return false;                     // negative
    const Py_ssize_t nd = static_cast<Py_ssize_t>(tag >> 3);
    const digit* d = x->long_value.ob_digit;
#else
    const Py_ssize_t nd = Py_SIZE(x);
    if (nd < 0) return false;
    const digit* d = x->ob_digit;
#endif
    if (nd * PyLong_SHIFT > 256 + PyLong_SHIFT) return false;   // >= 2^256
    unsigned __int128 acc = 0;
    int bits = 0, k = 0;
    for (Py_ssize_t i = 0; i < nd; ++i) {
        acc |= static_cast<unsigned __int128>(d[i]) << bits;
        bits += PyLong_SHIFT;
        if (bits >= 64) {
            if (k == 4) return false;
            w[k++] = static_cast<uint64_t>(acc);
            acc >>= 64;
            bits -= 64;
        }
    }
    if (k < 4) {
        w[k++] = static_cast<uint64_t>(acc);
        while (k < 4) w[k++] = 0;
    } else if (acc != 0) {
        return false;
    }
    for (int j = 3; j >= 0; --j)
        if (w[j] != R64[j]) return w[j] < R64[j];
    return false;                                         // == r
}

// Python's int(v) % r as four words; false with an exception set.
bool reduced_words(PyObject* v, PyObject* r, uint64_t w[4]) {
    PyObject* i = PyNumber_Long(v);
    if (i == nullptr) return false;
    PyObject* m = PyNumber_Remainder(i, r);
    Py_DECREF(i);
    if (m == nullptr) return false;
    const bool ok = canonical_words(m, w);
    Py_DECREF(m);
    if (!ok) PyErr_SetString(PyExc_ValueError, "int(v) % r outside [0, r)");
    return ok;
}

}  // namespace

extern "C" {

// The values of the sequences in ``lists`` (a tuple), one after the other,
// as canonical words into ``out``: (8, n) int32, row k at out + k * n.  n
// must be their total length.  Returns how many values were not exact ints
// in [0, r) (reduced as int(v) % r), or -1 with an exception set.
int64_t pm_fr_pack(PyObject* lists, PyObject* r, int32_t* out, int64_t n) {
    if (!PyTuple_Check(lists)) {
        PyErr_SetString(PyExc_TypeError, "pm_fr_pack: lists must be a tuple");
        return -1;
    }
    uint32_t* words = reinterpret_cast<uint32_t*>(out);
    int64_t col = 0, odd = 0;
    for (Py_ssize_t t = 0; t < PyTuple_GET_SIZE(lists); ++t) {
        PyObject* seq = PySequence_Fast(PyTuple_GET_ITEM(lists, t),
                                        "pm_fr_pack: a list is not a sequence");
        if (seq == nullptr) return -1;
        const Py_ssize_t len = PySequence_Fast_GET_SIZE(seq);
        if (col + len > n) {
            Py_DECREF(seq);
            PyErr_SetString(PyExc_ValueError, "pm_fr_pack: more values than n");
            return -1;
        }
        for (Py_ssize_t i = 0; i < len; ++i, ++col) {
            PyObject* v = PySequence_Fast_ITEMS(seq)[i];
            uint64_t w[4];
            if (!canonical_words(v, w)) {
                // int(v) may run Python code that changes the list: hold v,
                // and stop if the list's length moved
                Py_INCREF(v);
                const bool ok = reduced_words(v, r, w);
                Py_DECREF(v);
                if (ok && PySequence_Fast_GET_SIZE(seq) != len) {
                    PyErr_SetString(PyExc_RuntimeError,
                                    "pm_fr_pack: a list changed size");
                    Py_DECREF(seq);
                    return -1;
                }
                if (!ok) {
                    Py_DECREF(seq);
                    return -1;
                }
                ++odd;
            }
            for (int k = 0; k < 4; ++k) {
                words[(2 * k) * n + col] = static_cast<uint32_t>(w[k]);
                words[(2 * k + 1) * n + col] = static_cast<uint32_t>(w[k] >> 32);
            }
        }
        Py_DECREF(seq);
    }
    if (col != n) {
        PyErr_SetString(PyExc_ValueError, "pm_fr_pack: fewer values than n");
        return -1;
    }
    return odd;
}

// 1 if every element of the list or tuple ``seq`` is an exact int in
// [0, r), else 0; -1 with an exception set if seq is neither.
int pm_fr_all_canonical(PyObject* seq) {
    if (!PyList_Check(seq) && !PyTuple_Check(seq)) {
        PyErr_SetString(PyExc_TypeError,
                        "pm_fr_all_canonical: expected a list or tuple");
        return -1;
    }
    PyObject** items = PySequence_Fast_ITEMS(seq);
    uint64_t w[4];
    for (Py_ssize_t i = 0; i < PySequence_Fast_GET_SIZE(seq); ++i)
        if (!canonical_words(items[i], w)) return 0;
    return 1;
}

}  // extern "C"

#endif  // PM_HAVE_PYTHON_H
