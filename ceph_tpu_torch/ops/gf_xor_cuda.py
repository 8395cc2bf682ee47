"""Kernel B6 on Hopper: the XOR-strip transform (csrc/gf_xor.cu).

Replaces ``ceph_tpu/ops/gf_xor_pallas.py::_xor_kernel`` (launched by
``_xor_encode_padded``). The schedule of a matrix (output strip r = XOR of
the input strips ``schedule[r]`` lists) travels as a CSR table, uploaded
once per matrix and device; a block stages one tile of every input strip
in shared memory and XORs each output row from it. See the source for the
design and its bound.

:func:`xor_strips` launches the kernel for a CUDA tensor or raises; for a
CPU tensor it runs the plain version (ops/gf_xor_torch.py).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ceph_tpu_torch.ops import cuda_build, gf_xor_torch

#: largest matrix the kernel takes, as B1's (ops/gf_cuda.py): 128 input
#: chunks are 1024 strips, staged 16 words each in 64 KiB of shared memory
MAX_K_IN, MAX_M_OUT = 128, 32

#: launches of the CUDA kernel since the last reset (plain runs not counted)
launches = 0

_NAME = "gf_xor"


def reset_launches() -> None:
    global launches
    launches = 0


def schedule_arrays(schedule) -> dict[str, np.ndarray]:
    """The schedule as the kernel's CSR table: ``row_off`` [R + 1] int32
    (row r's terms are idx[row_off[r]:row_off[r + 1]]) and ``idx`` [nnz]
    int32."""
    off = np.cumsum([0] + [len(t) for t in schedule]).astype(np.int32)
    idx = np.asarray([j for t in schedule for j in t], dtype=np.int32)
    return {"row_off": off, "idx": idx}


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(_NAME)
    fn = lib.gf_xor_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def xor_strips(schedule, arrays: cuda_build.DeviceArrays, k_in: int,
               strips: torch.Tensor) -> torch.Tensor:
    """strips [8 k_in, B, 128] int32 -> [len(schedule), B, 128] int32 on
    strips' device, where ``arrays`` holds ``schedule_arrays(schedule)``.
    On CUDA the kernel runs on the current stream (no synchronisation)."""
    if not strips.is_cuda:
        return gf_xor_torch.xor_strips(schedule, strips)
    rows = len(schedule)
    if k_in > MAX_K_IN or rows > 8 * MAX_M_OUT:
        raise ValueError(f"matrix {rows // 8}x{k_in} exceeds the kernel's "
                         f"{MAX_M_OUT}x{MAX_K_IN} limit")
    if strips.dtype != torch.int32 or strips.dim() != 3 or \
            strips.shape[0] != 8 * k_in or strips.shape[2] != 128:
        raise ValueError(f"strips must be [{8 * k_in}, B, 128] int32, got "
                         f"{tuple(strips.shape)} {strips.dtype}")
    if not strips.is_contiguous() or strips.data_ptr() % 16:
        raise ValueError("strips must be contiguous and 16-byte aligned")
    out = torch.empty((rows,) + tuple(strips.shape[1:]), dtype=torch.int32,
                      device=strips.device)
    words = strips.shape[1] * 128
    if words == 0:
        return out
    arr = arrays.on(strips.device)
    lib = _lib()
    stream = torch.cuda.current_stream(strips.device).cuda_stream
    with torch.cuda.device(strips.device):
        err = lib.gf_xor_launch(arr["row_off"].data_ptr(),
                                arr["idx"].data_ptr(), strips.data_ptr(),
                                out.data_ptr(), 8 * k_in, rows, words, stream)
    cuda_build.check(lib, err, "gf_xor launch")
    global launches
    launches += 1
    return out
