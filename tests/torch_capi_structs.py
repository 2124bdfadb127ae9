"""ctypes mirrors of cbindings/blitzar_tpu_api.h's structs and callback,
shared by the C ABI's drivers (tests/torch_capi_driver.py on the CPU,
tests/torch_capi_card_driver.py on the card). Imports ctypes alone."""

import ctypes


class SequenceDescriptor(ctypes.Structure):
    _fields_ = [("element_nbytes", ctypes.c_uint8), ("n", ctypes.c_uint64),
                ("data", ctypes.POINTER(ctypes.c_uint8)), ("is_signed", ctypes.c_int)]


class Config(ctypes.Structure):
    _fields_ = [("backend", ctypes.c_int), ("num_precomputed_generators", ctypes.c_uint64)]


class SumcheckDescriptor(ctypes.Structure):
    _fields_ = [("mles", ctypes.c_void_p), ("product_table", ctypes.c_void_p),
                ("product_terms", ctypes.POINTER(ctypes.c_uint32)), ("n", ctypes.c_uint32),
                ("num_mles", ctypes.c_uint32), ("num_products", ctypes.c_uint32),
                ("num_product_terms", ctypes.c_uint32), ("round_degree", ctypes.c_uint32)]


# void (*)(r, context, polynomial, polynomial_len): the sumcheck's challenge
CALLBACK = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint)


def load(path: str) -> ctypes.CDLL:
    """The library, with the restypes of the entries that return a handle."""
    lib = ctypes.CDLL(path)
    lib.sxt_multiexp_handle_new.restype = ctypes.c_void_p
    lib.sxt_multiexp_handle_new_from_file.restype = ctypes.c_void_p
    return lib


def init(lib: ctypes.CDLL, backend: int, num_precomputed_generators: int = 0) -> int:
    return lib.sxt_init(ctypes.byref(Config(backend, num_precomputed_generators)))
