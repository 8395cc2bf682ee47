"""Kernels B3 and B4 on Hopper: the Clay structured encode
(csrc/clay_encode.cu) and the Clay multi-level layered decode
(csrc/clay_transform.cu).

- B3 replaces ``ceph_tpu/models/clay_device.py::build_encode_kernel``
  (inner ``kernel``): the TPU kernel routes (node, plane) rows with 0/1
  bf16 matmuls and multiplies by per-row coefficients with bit-plane
  select chains; here a thread gathers the rows by index and multiplies
  packed bytes by a constant with shift-and-xor.
- B4 replaces ``ceph_tpu/models/clay_device.py::build_transform_kernel``
  (inner ``kernel``): same translation, with the two state arrays (C and
  U) of a narrow lane tile in shared memory and the levels as CSR row
  lists instead of masks over every row.

The structure tables come from models/clay_device.py
(``encode_kernel_arrays``, ``transform_kernel_arrays``); the classes here
upload them once per device and launch. Each ``__call__`` takes a CUDA
tensor and launches its kernel or raises; the callers in
models/clay_device.py run the plain versions for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ceph_tpu_torch.ops import cuda_build

#: launches of each CUDA kernel since the last reset (plain runs not counted)
encode_launches = 0
transform_launches = 0

#: shared memory a block may use (H100: 227 KiB)
MAX_SMEM = 227 * 1024

#: B4's state budget per block: below MAX_SMEM so two blocks fit an SM
_TRANSFORM_SMEM = 100 * 1024

_ptr = ctypes.c_void_p
_int = ctypes.c_int


def reset_launches() -> None:
    global encode_launches, transform_launches
    encode_launches = transform_launches = 0


def _check_input(x: torch.Tensor, rows: int, what: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: needs a CUDA tensor")
    if x.dtype != torch.uint8 or x.dim() != 3 or \
            x.shape[0] * x.shape[1] != rows:
        raise ValueError(f"{what}: input must be uint8 with {rows} rows, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")


def _encode_lib() -> ctypes.CDLL:
    lib = cuda_build.load("clay_encode")
    fn = lib.clay_encode_launch
    fn.argtypes = [_ptr] * 10 + [_ptr, _ptr, _int, _int, _int,
                                 ctypes.c_longlong, _int, _ptr]
    fn.restype = _int
    return lib


def _transform_lib() -> ctypes.CDLL:
    lib = cuda_build.load("clay_transform")
    fn = lib.clay_transform_launch
    fn.argtypes = [_ptr] * 17 + [_ptr, _ptr, _int, _int, _int, _int, _int,
                                 ctypes.c_longlong, _int, _int, _ptr]
    fn.restype = _int
    return lib


class EncodeKernel:
    """Kernel B3: ``[k, ssc, L] uint8 -> [m, ssc, L]`` on the card."""

    #: lanes of a block's tile are 32 words of 4 bytes
    TILE_WORDS = 32

    def __init__(self, arrays: dict) -> None:
        self.k, self.m = arrays["k"], arrays["m"]
        self.kk, self.ssc = arrays["kk"], arrays["ssc"]
        self.smem = self.m * self.ssc * self.TILE_WORDS * 4
        self.tables = cuda_build.DeviceArrays(arrays)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        _check_input(x, self.k * self.ssc, "clay encode")
        if self.smem > MAX_SMEM:
            raise ValueError(
                f"clay encode kernel: m*ssc={self.m * self.ssc} parity "
                f"sub-chunks exceed one block's shared memory")
        L = x.shape[2]
        out = torch.empty((self.m, self.ssc, L), dtype=torch.uint8,
                          device=x.device)
        if L == 0:
            return out
        t = self.tables.on(x.device)
        vec = int(L % 4 == 0 and x.data_ptr() % 4 == 0)
        lib = _encode_lib()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with torch.cuda.device(x.device):
            err = lib.clay_encode_launch(
                t["ps_row"].data_ptr(), t["pa_row"].data_ptr(),
                t["a1"].data_ptr(), t["a2"].data_ptr(),
                t["dmat"].data_ptr(), t["pc_row"].data_ptr(),
                t["pu"].data_ptr(), t["b1"].data_ptr(), t["b2"].data_ptr(),
                t["b3"].data_ptr(), x.data_ptr(), out.data_ptr(),
                self.kk, self.m, self.ssc, L, vec, stream)
        cuda_build.check(lib, err, "clay_encode launch")
        global encode_launches
        encode_launches += 1
        return out


class TransformKernel:
    """Kernel B4: ``[qt, ssc, L] uint8 (erased rows zero) -> [e, ssc, L]``
    on the card."""

    def __init__(self, arrays: dict) -> None:
        self.qt, self.ssc = arrays["qt"], arrays["ssc"]
        self.kk, self.e = arrays["kk"], arrays["e"]
        self.n_levels = arrays["n_levels"]
        rows = self.qt * self.ssc
        # lane tile: the widest power-of-two word count (<= 32) whose C
        # and U state fits the budget
        tw = 32
        while tw > 1 and 2 * rows * tw * 4 > _TRANSFORM_SMEM:
            tw //= 2
        self.tile_words = tw
        self.smem = 2 * rows * tw * 4
        self.tables = cuda_build.DeviceArrays(arrays)

    def __call__(self, c_full: torch.Tensor) -> torch.Tensor:
        _check_input(c_full, self.qt * self.ssc, "clay transform")
        if self.smem > MAX_SMEM:
            raise ValueError(
                f"clay transform kernel: {self.qt * self.ssc} state rows "
                f"exceed one block's shared memory")
        L = c_full.shape[2]
        out = torch.empty((self.e, self.ssc, L), dtype=torch.uint8,
                          device=c_full.device)
        if L == 0:
            return out
        t = self.tables.on(c_full.device)
        vec = int(L % 4 == 0 and c_full.data_ptr() % 4 == 0)
        lib = _transform_lib()
        stream = torch.cuda.current_stream(c_full.device).cuda_stream
        names = ("a1", "a2", "pair", "b1", "b2", "b3", "p2", "u_off",
                 "u_rows", "p_off", "planes", "c_off", "c_rows", "intact",
                 "er", "dmat", "load")
        ptrs = [t[name].data_ptr() for name in names]
        with torch.cuda.device(c_full.device):
            err = lib.clay_transform_launch(
                *ptrs, c_full.data_ptr(), out.data_ptr(), self.qt,
                self.ssc, self.kk, self.e, self.n_levels, L, vec,
                self.tile_words, stream)
        cuda_build.check(lib, err, "clay_transform launch")
        global transform_launches
        transform_launches += 1
        return out
