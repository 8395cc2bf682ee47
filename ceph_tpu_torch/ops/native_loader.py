"""ctypes loader for the port's host native library.

Port of ``ceph_tpu/ops/native_loader.py``. The library holds what the
port's host layers need from the reference's ``ops/native/``: crc32c and
xxhash32/64 (``native/checksum.cc``, the checksum part of the reference's
``gf256.cc``), the blockstore's data-file engine (``native/io_engine.cc``)
and the LZ4-block and Snappy codecs (``native/lzcodecs.cc``). The host GF
matvec is left out: the port's host GF runs in numpy and torch.

Python<->native binding uses ctypes, and a ctypes call gives up the GIL
for its length, so a crc of a shard does not stall the other threads. On
first use the library is built with the reference's compiler and flags
(``g++ -O3 -std=c++17 -mavx2 -msse4.2``, its ``Makefile``) into
``build/torch_native/`` at the repository root, named by a hash of the
sources and flags (an unchanged library is not rebuilt within one
checkout). A missing compiler or a failed build raises
:class:`NativeBuildError`: there is no numpy fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
SOURCES = ("checksum.cc", "io_engine.cc", "lzcodecs.cc")
#: the reference's Makefile: CXXFLAGS then ARCHFLAGS
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall",
             "-mavx2", "-msse4.2")
#: seconds the compiler may take
BUILD_TIMEOUT_S = 300.0

_lock = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    """The host compiler is missing or refused the native sources."""


def lib_path() -> Path:
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libceph_tpu_torch_native-{h.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise NativeBuildError("g++ not found (set CXX)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # concurrent builds (test workers) each write their own file and
    # rename it into place: the rename is atomic, the outputs identical
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp),
           *(str(SRC_DIR / name) for name in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.SubprocessError) as exc:
        raise NativeBuildError(f"{cxx} failed to run: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"{' '.join(cmd)}: exit {proc.returncode}\n"
                               f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use; raises NativeBuildError."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            out = lib_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            _bind(lib)
            _lib = lib
    return _lib


def _bind(lib) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.ceph_crc32c.restype = ctypes.c_uint32
    lib.ceph_crc32c.argtypes = [ctypes.c_uint32, u8p, ctypes.c_uint64]
    lib.ceph_xxhash64.restype = ctypes.c_uint64
    lib.ceph_xxhash64.argtypes = [ctypes.c_uint64, u8p, ctypes.c_uint64]
    lib.ceph_xxhash32.restype = ctypes.c_uint32
    lib.ceph_xxhash32.argtypes = [ctypes.c_uint32, u8p, ctypes.c_uint64]
    lib.ioeng_open.restype = ctypes.c_int
    lib.ioeng_open.argtypes = [ctypes.c_char_p]
    lib.ioeng_size.restype = ctypes.c_int64
    lib.ioeng_size.argtypes = [ctypes.c_int]
    lib.ioeng_append.restype = ctypes.c_int64
    lib.ioeng_append.argtypes = [ctypes.c_int, u8p, ctypes.c_uint64,
                                 ctypes.c_uint32, u32p]
    lib.ioeng_read.restype = ctypes.c_int64
    lib.ioeng_read.argtypes = [ctypes.c_int, ctypes.c_uint64, u8p,
                               ctypes.c_uint64, ctypes.c_uint32, u32p]
    lib.ioeng_sync.restype = ctypes.c_int
    lib.ioeng_sync.argtypes = [ctypes.c_int]
    lib.ioeng_close.restype = ctypes.c_int
    lib.ioeng_close.argtypes = [ctypes.c_int]
    for fn in ("lz4_compress", "lz4_decompress", "snappy_compress",
               "snappy_decompress"):
        f = getattr(lib, fn)
        f.restype = ctypes.c_int64
        f.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
    for fn in ("lz4_max_compressed", "snappy_max_compressed"):
        f = getattr(lib, fn)
        f.restype = ctypes.c_int64
        f.argtypes = [ctypes.c_int64]
    lib.snappy_uncompressed_length.restype = ctypes.c_int64
    lib.snappy_uncompressed_length.argtypes = [u8p, ctypes.c_int64]


def _as_u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _buf(data) -> np.ndarray:
    """``data`` as a contiguous uint8 array (an ndarray's values cast to
    uint8, as the reference's loader does; any other buffer's bytes)."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data, np.uint8).reshape(-1)
    return np.frombuffer(memoryview(data), dtype=np.uint8)


def crc32c(data, crc: int = 0) -> int:
    """Standard CRC-32C (Castagnoli): crc32c(b"123456789") == 0xE3069283.
    Pass the previous value to continue a running crc."""
    buf = _buf(data)
    return int(get_lib().ceph_crc32c(ctypes.c_uint32(crc), _as_u8p(buf),
                                     buf.size))


def xxhash64(data, seed: int = 0) -> int:
    buf = _buf(data)
    return int(get_lib().ceph_xxhash64(ctypes.c_uint64(seed), _as_u8p(buf),
                                       buf.size))


def xxhash32(data, seed: int = 0) -> int:
    buf = _buf(data)
    return int(get_lib().ceph_xxhash32(ctypes.c_uint32(seed), _as_u8p(buf),
                                       buf.size))


def _lz_roundtrip(name: str, data, op: str) -> bytes:
    lib = get_lib()
    buf = np.frombuffer(memoryview(bytes(data)), dtype=np.uint8)
    if op == "c":
        cap = int(getattr(lib, f"{name}_max_compressed")(buf.size))
    elif name == "snappy":
        cap = int(lib.snappy_uncompressed_length(_as_u8p(buf), buf.size)) \
            if buf.size else 0
        # the header varint is untrusted blob bytes: clamp against
        # snappy's max expansion (<64x) BEFORE allocating, or a
        # corrupt prefix commits terabytes
        if cap < 0 or cap > max(buf.size * 64, 1 << 16):
            raise ValueError("corrupt snappy header")
    else:
        # LZ4 block carries no length header: the compressor layer
        # prepends it (lz4_decompress takes it)
        raise ValueError("lz4 decompress needs an explicit capacity")
    out = np.empty(max(cap, 1), dtype=np.uint8)
    fn = getattr(lib, f"{name}_{'compress' if op == 'c' else 'decompress'}")
    got = int(fn(_as_u8p(buf), buf.size, _as_u8p(out), out.size))
    if got < 0:
        raise ValueError(f"{name} codec error")
    return out[:got].tobytes()


def snappy_compress(data) -> bytes:
    return _lz_roundtrip("snappy", data, "c")


def snappy_decompress(data) -> bytes:
    return _lz_roundtrip("snappy", data, "d")


def lz4_compress(data) -> bytes:
    return _lz_roundtrip("lz4", data, "c")


def lz4_decompress(data, raw_len: int) -> bytes:
    lib = get_lib()
    buf = np.frombuffer(memoryview(bytes(data)), dtype=np.uint8)
    out = np.empty(max(raw_len, 1), dtype=np.uint8)
    got = int(lib.lz4_decompress(_as_u8p(buf), buf.size, _as_u8p(out),
                                 raw_len))
    if got != raw_len:
        raise ValueError("lz4 codec error")
    return out[:got].tobytes()
