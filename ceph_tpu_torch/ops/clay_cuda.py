"""Kernels B3 and B4 on Hopper: the Clay structured encode
(csrc/clay_encode.cu) and the Clay multi-level layered decode
(csrc/clay_transform.cu).

- B3 replaces ``ceph_tpu/models/clay_device.py::build_encode_kernel``
  (inner ``kernel``): the TPU kernel routes (node, plane) rows with 0/1
  bf16 matmuls and multiplies by per-row coefficients with bit-plane
  select chains; here a thread gathers rows by index, holds 32 lanes as
  8 bit planes and multiplies by a constant along the multiply-by-x
  chain, branch-free. :func:`launch_plan` picks its form from L and the
  SM count: a full form over (plane, lane group) and, where that grid
  would leave SMs idle, a short form over (plane, lane group, MDS term).
- B4 replaces ``ceph_tpu/models/clay_device.py::build_transform_kernel``
  (inner ``kernel``): the same bit-sliced arithmetic, with the two state
  arrays (C and U) of a tile of lane groups in shared memory in bit-plane
  form and the levels as CSR row lists instead of masks over every row.
  :func:`transform_plan` is the one source of its tile, block size and
  grid.

The structure tables come from models/clay_device.py
(``encode_kernel_arrays``, ``transform_kernel_arrays``); the classes here
upload them once per device and launch. Each ``__call__`` takes a CUDA
tensor and launches its kernel or raises; the callers in
models/clay_device.py run the plain versions for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ceph_tpu_torch.ops import cuda_build

#: launches of each CUDA kernel since the last reset (plain runs not counted)
encode_launches = 0
transform_launches = 0

#: shared memory a block may use (H100: 227 KiB)
MAX_SMEM = 227 * 1024

#: B3's launch forms (csrc/clay_encode.cu): the full form's block size and
#: most lane groups of 32 per tile, its u_p budget per block (two blocks
#: an SM), the short form's lane groups and most threads, and the most
#: MDS coefficients the kernel's parameters carry
FULL_THREADS = 256
FULL_GROUPS = 8
_ENCODE_SMEM = 100 * 1024
SHORT_GROUPS = 2
SHORT_THREADS = 1024
MAX_DMAT = 1024

#: B4's launch: most lane groups of 32 per block, and threads per lane
#: group (bench/b4_ab.py: 2 groups of 256 threads beat 1 and 4 groups, and
#: 128 threads a group, on an H100)
TRANSFORM_GROUPS = 2
TRANSFORM_GROUP_THREADS = 256

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


_encode = None


def _encode_lib() -> tuple[ctypes.CDLL, object]:
    """(library, launcher) of B3, the launcher's ctypes signature set once
    when the library loads."""
    global _encode
    if _encode is None:
        lib = cuda_build.load("clay_encode")
        fn = lib.clay_encode_launch
        fn.argtypes = [_ptr] * 12 + [_int, _int, _int, _ptr,
                                     ctypes.c_longlong, _int, _int, _int,
                                     _int, _ptr]
        fn.restype = _int
        _encode = lib, fn
    return _encode


def transform_launcher(lib: ctypes.CDLL):
    """B4's launcher in ``lib`` (the committed build or an A/B variant
    with its C interface), its ctypes signature set."""
    fn = lib.clay_transform_launch
    fn.argtypes = [_ptr] * 12 + [_int] * 5 + [ctypes.c_longlong] + \
        [_int] * 5 + [_ptr]
    fn.restype = _int
    return fn


_transform = None


def _transform_lib() -> tuple[ctypes.CDLL, object]:
    """(library, launcher) of B4, the signature set once when the library
    loads."""
    global _transform
    if _transform is None:
        lib = cuda_build.load("clay_transform")
        _transform = lib, transform_launcher(lib)
    return _transform


class LaunchPlan(NamedTuple):
    """One B3 launch: form, lane groups of 32 per block, block size,
    blocks, dynamic shared memory bytes."""
    split: bool
    groups: int
    threads: int
    blocks: int
    smem: int


def launch_plan(L: int, m: int, ssc: int, kk: int, sms: int) -> LaunchPlan:
    """B3's launch form for L lanes on a card of ``sms`` SMs.

    The full form tiles L by 32*G lanes (G <= 8, as large as keeps two
    blocks' u_p within an SM) with 256 threads over (plane, lane group).
    Where that grid has fewer blocks than the card has SMs, the short form
    takes tiles of 64 lanes (32 if u_p would not fit) with up to 1,024
    threads over (plane, lane group, MDS term). Raises ValueError where
    one lane group's u_p (m*ssc*32 bytes) exceeds a block's shared
    memory."""
    rows = m * ssc
    if rows * 32 > MAX_SMEM:
        raise ValueError(
            f"clay encode kernel: m*ssc={rows} parity sub-chunks exceed one "
            f"block's shared memory")
    g = FULL_GROUPS
    while g > 1 and rows * 32 * g > _ENCODE_SMEM:
        g //= 2
    blocks = -(-L // (32 * g))
    if blocks >= sms:
        return LaunchPlan(False, g, FULL_THREADS, blocks, rows * 32 * g)
    g = SHORT_GROUPS if rows * 32 * SHORT_GROUPS <= MAX_SMEM else 1
    work = max(ssc * g * kk, rows * g)
    threads = min(SHORT_THREADS, -(-work // 32) * 32)
    return LaunchPlan(True, g, threads, -(-L // (32 * g)), rows * 32 * g)


class TransformPlan(NamedTuple):
    """One B4 launch: lane groups of 32 per block, block size, blocks,
    dynamic shared memory bytes."""
    groups: int
    threads: int
    blocks: int
    smem: int


def transform_plan(L: int, qt: int, ssc: int, sms: int,
                   groups: int = TRANSFORM_GROUPS,
                   threads: int | None = None) -> TransformPlan:
    """B4's launch for L lanes of a qt-node, ssc-plane signature on a card
    of ``sms`` SMs: tiles of ``groups`` lane groups (1, 2 or 4; halved
    until the state fits a block, and while the grid would leave SMs
    idle), ``threads`` (default 256 a lane group; the kernel takes at
    most 512) a block, the least grid that covers L. A block holds C and
    U of each lane group, 2 * qt*ssc rows of 32 bytes. Raises ValueError
    where one lane group's state exceeds a block's shared memory."""
    state = 64 * qt * ssc
    if state > MAX_SMEM:
        raise ValueError(
            f"clay transform kernel: qt*ssc={qt * ssc} state rows exceed "
            f"one block's shared memory")
    g = groups
    while g > 1 and (state * g > MAX_SMEM or -(-L // (32 * g)) < sms):
        g //= 2
    return TransformPlan(g, threads or TRANSFORM_GROUP_THREADS * g,
                         -(-L // (32 * g)), state * g)


def _top_bit(table: np.ndarray) -> int:
    """The highest set bit over a coefficient table, -1 if all zero."""
    return int(np.bitwise_or.reduce(table.reshape(-1).astype(np.int64),
                                    initial=0)).bit_length() - 1


_sms: dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device (with its index), read once per
    device."""
    n = _sms.get(device.index)
    if n is None:
        n = _sms[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


class EncodeKernel:
    """Kernel B3: ``[k, ssc, L] uint8 -> [m, ssc, L]`` on the card."""

    #: tables on the device, in the launcher's argument order
    TABLES = ("ps_row", "pa_row", "a1", "a2", "pc_row", "pu", "b1", "b2",
              "b3")

    def __init__(self, arrays: dict) -> None:
        self.k, self.m = arrays["k"], arrays["m"]
        self.kk, self.ssc = arrays["kk"], arrays["ssc"]
        self.dmat = np.ascontiguousarray(arrays["dmat"], dtype=np.uint8)
        self._top_bits = (ctypes.c_int * 6)(*(
            _top_bit(arrays[name]) for name in
            ("a1", "a2", "dmat", "b1", "b2", "b3")))
        self.top_bits = ctypes.addressof(self._top_bits)
        self.tables = cuda_build.DeviceArrays(
            {name: arrays[name] for name in self.TABLES})
        self._ptrs: dict[torch.device, tuple[int, ...]] = {}

    def _table_ptrs(self, device: torch.device) -> tuple[int, ...]:
        ptrs = self._ptrs.get(device)
        if ptrs is None:
            t = self.tables.on(device)
            ptrs = self._ptrs[device] = tuple(
                t[name].data_ptr() for name in self.TABLES) + (
                self.dmat.ctypes.data,)
        return ptrs

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        _check_input(x, self.k * self.ssc, "clay encode")
        if self.m * self.kk > MAX_DMAT:
            raise ValueError(f"clay encode kernel: m*kk={self.m * self.kk} "
                             f"MDS coefficients exceed {MAX_DMAT}")
        L = x.shape[2]
        dev = x.device
        plan = launch_plan(L, self.m, self.ssc, self.kk, _sm_count(dev))
        out = torch.empty((self.m, self.ssc, L), dtype=torch.uint8,
                          device=dev)
        if L == 0:
            return out
        lib, fn = _encode_lib()
        ptrs = self._table_ptrs(dev)
        src, dst = x.data_ptr(), out.data_ptr()
        vec = int(L % 16 == 0 and src % 16 == 0 and dst % 16 == 0)
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = (*ptrs, src, dst, self.kk, self.m, self.ssc, self.top_bits,
                L, vec, int(plan.split), plan.groups, plan.threads, stream)
        if dev.index == torch.cuda.current_device():
            err = fn(*args)
        else:
            with torch.cuda.device(dev):
                err = fn(*args)
        cuda_build.check(lib, err, "clay_encode launch")
        global encode_launches
        encode_launches += 1
        return out


def transform_items(arrays: dict, by_coef: bool = True
                    ) -> tuple[np.ndarray, np.ndarray]:
    """B4's phase-1 and phase-2 rows of ``transform_kernel_arrays`` as
    items: [n, 4] int32 (row, partner, coefficients, output row), phase 1
    with ``a1 | a2 << 8``, partner ``pair`` and output row 0, phase 2 with
    ``b1 | b2 << 8 | b3 << 16``, partner ``p2`` and the row's place in the
    output (j*ssc + z for row er[j]*ssc + z: phase 2 writes every erased
    row, once). Each level's items keep their place in the CSR lists
    (``u_off``, ``c_off``) and are ordered by their coefficients there
    (``by_coef``; False keeps the lists' order, for bench/b4_ab.py), so
    that a warp's items mostly share them and its masked chains stop at
    their highest set bit."""
    ssc = arrays["ssc"]
    out_row = np.zeros(arrays["qt"] * ssc, dtype=np.int32)
    for j, n in enumerate(arrays["er"]):
        out_row[n * ssc:(n + 1) * ssc] = np.arange(j * ssc, (j + 1) * ssc)
    c_rows = np.sort(arrays["c_rows"])
    assert np.array_equal(c_rows, np.sort(
        np.asarray(arrays["er"])[:, None] * ssc + np.arange(ssc)).ravel()), \
        "phase 2 must write every erased row once"

    def pack(rows, partner, coef, off, out):
        items = np.zeros((len(rows), 4), dtype=np.int32)
        items[:, 0], items[:, 1], items[:, 2], items[:, 3] = \
            rows, partner[rows], coef[rows], out[rows]
        for li in range(len(off) - 1 if by_coef else 0):
            lvl = items[off[li]:off[li + 1]]
            lvl[:] = lvl[np.argsort(lvl[:, 2], kind="stable")]
        return items

    a = {name: arrays[name].astype(np.int32) for name in
         ("a1", "a2", "b1", "b2", "b3")}
    return (pack(arrays["u_rows"], arrays["pair"], a["a1"] | a["a2"] << 8,
                 arrays["u_off"], np.zeros_like(out_row)),
            pack(arrays["c_rows"], arrays["p2"],
                 a["b1"] | a["b2"] << 8 | a["b3"] << 16, arrays["c_off"],
                 out_row))


class TransformKernel:
    """Kernel B4: ``[qt, ssc, L] uint8 (erased rows zero) -> [e, ssc, L]``
    on the card."""

    #: tables on the device, in the launcher's argument order; intact, er,
    #: dmat and load (host arrays, copied into the kernel's parameters)
    #: follow
    TABLES = ("u_items", "u_off", "p_off", "planes", "c_items", "c_off")
    HOST = ("intact", "er", "dmat", "load")

    def __init__(self, arrays: dict) -> None:
        self.qt, self.ssc = arrays["qt"], arrays["ssc"]
        self.kk, self.e = arrays["kk"], arrays["e"]
        self.n_levels = arrays["n_levels"]
        self.host = {name: np.ascontiguousarray(arrays[name])
                     for name in self.HOST}
        u_items, c_items = transform_items(arrays)
        self.tables = cuda_build.DeviceArrays({
            "u_items": u_items, "c_items": c_items,
            **{name: arrays[name] for name in ("u_off", "p_off", "planes",
                                               "c_off")}})
        self._ptrs: dict[torch.device, tuple[int, ...]] = {}

    def _table_ptrs(self, device: torch.device) -> tuple[int, ...]:
        ptrs = self._ptrs.get(device)
        if ptrs is None:
            t = self.tables.on(device)
            ptrs = self._ptrs[device] = tuple(
                t[name].data_ptr() for name in self.TABLES) + tuple(
                self.host[name].ctypes.data for name in self.HOST)
        return ptrs

    def __call__(self, c_full: torch.Tensor,
                 plan: TransformPlan | None = None,
                 launcher: tuple[ctypes.CDLL, object] | None = None
                 ) -> torch.Tensor:
        """Launch on ``c_full``'s device. ``plan`` (default
        :func:`transform_plan`'s) and ``launcher`` (library, function;
        default the committed build) are bench/b4_ab.py's variants."""
        _check_input(c_full, self.qt * self.ssc, "clay transform")
        if self.e * self.kk > MAX_DMAT:
            raise ValueError(f"clay transform kernel: e*kk="
                             f"{self.e * self.kk} MDS coefficients exceed "
                             f"{MAX_DMAT}")
        L = c_full.shape[2]
        dev = c_full.device
        out = torch.empty((self.e, self.ssc, L), dtype=torch.uint8,
                          device=dev)
        if L == 0:
            return out
        if plan is None:
            plan = transform_plan(L, self.qt, self.ssc, _sm_count(dev))
        lib, fn = launcher or _transform_lib()
        src, dst = c_full.data_ptr(), out.data_ptr()
        vec = int(L % 16 == 0 and src % 16 == 0 and dst % 16 == 0)
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = (*self._table_ptrs(dev), src, dst, self.qt, self.ssc,
                self.kk, self.e, self.n_levels, L, vec, plan.groups,
                plan.blocks, plan.threads, plan.smem, stream)
        if dev.index == torch.cuda.current_device():
            err = fn(*args)
        else:
            with torch.cuda.device(dev):
                err = fn(*args)
        cuda_build.check(lib, err, "clay_transform launch")
        global transform_launches
        transform_launches += 1
        return out
