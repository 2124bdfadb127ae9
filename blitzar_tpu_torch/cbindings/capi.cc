// The C ABI (cbindings/blitzar_tpu_api.h) over blitzar_tpu_torch.
//
// A stable extern "C" surface over the port: every sxt_* entry forwards
// its raw pointers (as uintptr_t) and sizes into
// blitzar_tpu_torch/capi_bridge.py, which parses the reference's structs,
// calls the port's Python API on the card and writes the results back.
// Built into libblitzar_tpu.so by blitzar_tpu_torch/cbindings/build.py,
// against the one header cbindings/blitzar_tpu_api.h (by -I).
//
// Loaded into a running Python (ctypes), the shim uses that interpreter.
// In a process with none (a C or Rust consumer) the first call starts one
// from the Python the library was built with (BLITZAR_TPU_PYTHON, so its
// sys.prefix and site-packages, torch among them) and appends the
// checkout's root (BLITZAR_TPU_ROOT) to sys.path, so the consumer needs no
// PYTHONPATH. Misuse aborts with a message (reference base/error/panic.h).

#include "blitzar_tpu_api.h"

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdarg>
#include <cstdio>
#include <cstdlib>
#include <mutex>

#ifndef BLITZAR_TPU_PYTHON
#error "build with -DBLITZAR_TPU_PYTHON=\"<sys.executable>\" (blitzar_tpu_torch/cbindings/build.py)"
#endif
#ifndef BLITZAR_TPU_ROOT
#error "build with -DBLITZAR_TPU_ROOT=\"<checkout root>\" (blitzar_tpu_torch/cbindings/build.py)"
#endif

namespace {

void panic(const char* msg) {
  std::fprintf(stderr, "blitzar_tpu panic: %s\n", msg);
  if (PyErr_Occurred() != nullptr) {
    PyErr_Print();
  }
  std::abort();
}

void check_status(PyStatus status, const char* what) {
  if (PyStatus_Exception(status)) {
    std::fprintf(stderr, "blitzar_tpu panic: %s: %s\n", what,
                 status.err_msg != nullptr ? status.err_msg : "");
    std::abort();
  }
}

// Start the interpreter from the build's Python, once. MUST run before any
// PyGILState_Ensure: in a pure-C consumer the first ABI call is what brings
// the interpreter up. After the start the calling thread owns the GIL; it
// hands it back with PyEval_SaveThread so that every entry point (from any
// thread) takes it through the PyGILState API alike.
void ensure_python() {
  static std::once_flag once;
  std::call_once(once, [] {
    if (Py_IsInitialized()) {
      return;
    }
    PyConfig config;
    PyConfig_InitPythonConfig(&config);
    config.install_signal_handlers = 0;
    check_status(PyConfig_SetBytesString(&config, &config.program_name, BLITZAR_TPU_PYTHON),
                 "setting the program name");
    check_status(Py_InitializeFromConfig(&config), "starting Python");
    PyConfig_Clear(&config);
    PyEval_SaveThread();
  });
}

// Import the bridge once, with the checkout's root on sys.path.
PyObject* bridge() {
  static PyObject* mod = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    PyObject* path = PySys_GetObject("path");  // borrowed
    PyObject* root = PyUnicode_FromString(BLITZAR_TPU_ROOT);
    if (path == nullptr || root == nullptr) {
      panic("sys.path is missing");
    }
    int found = PySequence_Contains(path, root);
    if (found < 0 || (found == 0 && PyList_Append(path, root) != 0)) {
      panic("extending sys.path failed");
    }
    Py_DECREF(root);
    mod = PyImport_ImportModule("blitzar_tpu_torch.capi_bridge");
    if (mod == nullptr) {
      panic("failed to import blitzar_tpu_torch.capi_bridge from " BLITZAR_TPU_ROOT);
    }
  });
  return mod;
}

struct GIL {
  PyGILState_STATE state;
  GIL() {
    ensure_python();
    state = PyGILState_Ensure();
  }
  ~GIL() { PyGILState_Release(state); }
};

// Call a bridge function; returns the result object (new reference).
PyObject* call(const char* name, const char* fmt, ...) {
  PyObject* fn = PyObject_GetAttrString(bridge(), name);
  if (fn == nullptr) {
    panic(name);
  }
  va_list args;
  va_start(args, fmt);
  PyObject* tuple = Py_VaBuildValue(fmt, args);
  va_end(args);
  if (tuple == nullptr) {
    panic("argument marshalling failed");
  }
  PyObject* res = PyObject_CallObject(fn, tuple);
  Py_DECREF(tuple);
  Py_DECREF(fn);
  if (res == nullptr) {
    panic(name);
  }
  return res;
}

uint64_t as_u64(PyObject* obj, const char* what) {
  uint64_t v = PyLong_AsUnsignedLongLong(obj);
  if (PyErr_Occurred() != nullptr) {
    panic(what);
  }
  Py_DECREF(obj);
  return v;
}

using ull = unsigned long long;

ull uptr(const void* p) { return static_cast<ull>(reinterpret_cast<uintptr_t>(p)); }

// The longest column: how many generators the bridge reads.
uint64_t max_length(uint32_t num_sequences, const struct sxt_sequence_descriptor* descriptors) {
  uint64_t n = 0;
  for (uint32_t i = 0; i < num_sequences; ++i) {
    if (descriptors[i].n > n) {
      n = descriptors[i].n;
    }
  }
  return n;
}

void commit_with_generators(const char* bridge_name, void* commitments, uint32_t num_sequences,
                            const struct sxt_sequence_descriptor* descriptors,
                            const void* generators) {
  GIL gil;
  Py_DECREF(call(bridge_name, "(KKKKK)", uptr(commitments), (ull)num_sequences, uptr(descriptors),
                 uptr(generators), (ull)max_length(num_sequences, descriptors)));
}

}  // namespace

extern "C" {

int sxt_init(const struct sxt_config* config) {
  if (config == nullptr) {
    panic("config must not be null");
  }
  GIL gil;
  PyObject* res = call("init", "(iK)", config->backend, (ull)config->num_precomputed_generators);
  return (int)as_u64(res, "init");
}

void sxt_curve25519_compute_pedersen_commitments(
    struct sxt_ristretto255_compressed* commitments, uint32_t num_sequences,
    const struct sxt_sequence_descriptor* descriptors, uint64_t offset_generators) {
  GIL gil;
  Py_DECREF(call("curve25519_compute_pedersen_commitments", "(KKKKKK)", uptr(commitments),
                 (ull)num_sequences, uptr(descriptors), 0ULL, 0ULL, (ull)offset_generators));
}

void sxt_curve25519_compute_pedersen_commitments_with_generators(
    struct sxt_ristretto255_compressed* commitments, uint32_t num_sequences,
    const struct sxt_sequence_descriptor* descriptors,
    const struct sxt_ristretto255* generators) {
  GIL gil;
  Py_DECREF(call("curve25519_compute_pedersen_commitments", "(KKKKKK)", uptr(commitments),
                 (ull)num_sequences, uptr(descriptors), uptr(generators),
                 (ull)max_length(num_sequences, descriptors), 0ULL));
}

void sxt_bls12_381_g1_compute_pedersen_commitments_with_generators(
    struct sxt_bls12_381_g1_compressed* commitments, uint32_t num_sequences,
    const struct sxt_sequence_descriptor* descriptors,
    const struct sxt_bls12_381_g1* generators) {
  commit_with_generators("bls12_381_g1_compute_pedersen_commitments", commitments, num_sequences,
                         descriptors, generators);
}

void sxt_bn254_g1_uncompressed_compute_pedersen_commitments_with_generators(
    struct sxt_bn254_g1* commitments, uint32_t num_sequences,
    const struct sxt_sequence_descriptor* descriptors, const struct sxt_bn254_g1* generators) {
  commit_with_generators("bn254_g1_uncompressed_compute_pedersen_commitments", commitments,
                         num_sequences, descriptors, generators);
}

void sxt_grumpkin_uncompressed_compute_pedersen_commitments_with_generators(
    struct sxt_grumpkin* commitments, uint32_t num_sequences,
    const struct sxt_sequence_descriptor* descriptors, const struct sxt_grumpkin* generators) {
  commit_with_generators("grumpkin_uncompressed_compute_pedersen_commitments", commitments,
                         num_sequences, descriptors, generators);
}

int sxt_ristretto255_get_generators(struct sxt_ristretto255* generators,
                                    uint64_t offset_generators, uint64_t num_generators) {
  GIL gil;
  PyObject* res = call("ristretto255_get_generators", "(KKK)", uptr(generators),
                       (ull)offset_generators, (ull)num_generators);
  return (int)as_u64(res, "get_generators");
}

int sxt_curve25519_get_one_commit(struct sxt_ristretto255* one_commit, uint64_t n) {
  GIL gil;
  PyObject* res = call("curve25519_get_one_commit", "(KK)", uptr(one_commit), (ull)n);
  return (int)as_u64(res, "get_one_commit");
}

void sxt_curve25519_prove_inner_product(
    struct sxt_ristretto255_compressed* l_vector, struct sxt_ristretto255_compressed* r_vector,
    struct sxt_curve25519_scalar* ap_value, struct sxt_transcript* transcript, uint64_t n,
    uint64_t generators_offset, const struct sxt_curve25519_scalar* a_vector,
    const struct sxt_curve25519_scalar* b_vector) {
  GIL gil;
  Py_DECREF(call("curve25519_prove_inner_product", "(KKKKKKKK)", uptr(l_vector), uptr(r_vector),
                 uptr(ap_value), uptr(transcript), (ull)n, (ull)generators_offset, uptr(a_vector),
                 uptr(b_vector)));
}

int sxt_curve25519_verify_inner_product(
    struct sxt_transcript* transcript, uint64_t n, uint64_t generators_offset,
    const struct sxt_curve25519_scalar* b_vector, const struct sxt_curve25519_scalar* product,
    const struct sxt_ristretto255* a_commit, const struct sxt_ristretto255_compressed* l_vector,
    const struct sxt_ristretto255_compressed* r_vector,
    const struct sxt_curve25519_scalar* ap_value) {
  GIL gil;
  PyObject* res = call("curve25519_verify_inner_product", "(KKKKKKKKK)", uptr(transcript), (ull)n,
                       (ull)generators_offset, uptr(b_vector), uptr(product), uptr(a_commit),
                       uptr(l_vector), uptr(r_vector), uptr(ap_value));
  return (int)as_u64(res, "verify_inner_product");
}

struct sxt_multiexp_handle* sxt_multiexp_handle_new(unsigned curve_id, const void* generators,
                                                    unsigned n) {
  GIL gil;
  PyObject* res = call("multiexp_handle_new", "(IKI)", curve_id, uptr(generators), n);
  return reinterpret_cast<struct sxt_multiexp_handle*>(
      (uintptr_t)as_u64(res, "multiexp_handle_new"));
}

struct sxt_multiexp_handle* sxt_multiexp_handle_new_from_file(unsigned curve_id,
                                                              const char* filename) {
  GIL gil;
  PyObject* res = call("multiexp_handle_new_from_file", "(Iy)", curve_id, filename);
  return reinterpret_cast<struct sxt_multiexp_handle*>(
      (uintptr_t)as_u64(res, "multiexp_handle_new_from_file"));
}

void sxt_multiexp_handle_write_to_file(const struct sxt_multiexp_handle* handle,
                                       const char* filename) {
  GIL gil;
  Py_DECREF(call("multiexp_handle_write_to_file", "(Ky)", uptr(handle), filename));
}

void sxt_multiexp_handle_free(struct sxt_multiexp_handle* handle) {
  GIL gil;
  Py_DECREF(call("multiexp_handle_free", "(K)", uptr(handle)));
}

void sxt_fixed_multiexponentiation(void* res, const struct sxt_multiexp_handle* handle,
                                   unsigned element_num_bytes, unsigned num_outputs, unsigned n,
                                   const uint8_t* scalars) {
  GIL gil;
  Py_DECREF(call("fixed_multiexponentiation", "(KKIIIK)", uptr(res), uptr(handle),
                 element_num_bytes, num_outputs, n, uptr(scalars)));
}

void sxt_fixed_packed_multiexponentiation(void* res, const struct sxt_multiexp_handle* handle,
                                          const unsigned* output_bit_table, unsigned num_outputs,
                                          unsigned n, const uint8_t* scalars) {
  GIL gil;
  Py_DECREF(call("fixed_packed_multiexponentiation", "(KKKIIK)", uptr(res), uptr(handle),
                 uptr(output_bit_table), num_outputs, n, uptr(scalars)));
}

void sxt_fixed_vlen_multiexponentiation(void* res, const struct sxt_multiexp_handle* handle,
                                        const unsigned* output_bit_table,
                                        const unsigned* output_lengths, unsigned num_outputs,
                                        const uint8_t* scalars) {
  GIL gil;
  Py_DECREF(call("fixed_vlen_multiexponentiation", "(KKKKIK)", uptr(res), uptr(handle),
                 uptr(output_bit_table), uptr(output_lengths), num_outputs, uptr(scalars)));
}

void sxt_prove_sumcheck(void* polynomials, void* evaluation_point, unsigned field_id,
                        const struct sumcheck_descriptor* descriptor, void* transcript_callback,
                        void* transcript_context) {
  if (descriptor == nullptr) {
    panic("descriptor must not be null");
  }
  GIL gil;
  Py_DECREF(call("prove_sumcheck", "(KKIKKKIIIIIKK)", uptr(polynomials), uptr(evaluation_point),
                 field_id, uptr(descriptor->mles), uptr(descriptor->product_table),
                 uptr(descriptor->product_terms), descriptor->n, descriptor->num_mles,
                 descriptor->num_products, descriptor->num_product_terms,
                 descriptor->round_degree, uptr(transcript_callback), uptr(transcript_context)));
}

}  // extern "C"
