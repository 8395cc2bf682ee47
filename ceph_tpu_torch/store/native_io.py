"""Native data-file engine for the blockstore (KernelDevice/aio role).

Port of ``ceph_tpu/store/native_io.py``. Wraps native/io_engine.cc
through ctypes: blob append with the crc32c computed in the same pass
over the hot buffer, pread-based blob reads (no shared seek position, so
concurrent readers need no lock), and fdatasync barriers. The file
format is raw concatenated blobs, identical to the pure-python twin
(``blockstore._PyDataFile``) and to the reference's, so a store written
by either package opens under the other. The port has no fallback: if
the native library cannot be built, :meth:`NativeDataFile.open` raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ceph_tpu_torch.ops.native_loader import get_lib


class NativeDataFile:
    """ctypes handle on the append-only blob file; API mirrors what
    blockstore needs (append/read/sync/size/close)."""

    def __init__(self, path: str, lib) -> None:
        self._lib = lib
        fd = lib.ioeng_open(path.encode())
        if fd < 0:
            raise OSError(-fd, f"ioeng_open({path})")
        self._fd = fd

    @classmethod
    def open(cls, path: str) -> "NativeDataFile":
        """Open (create) the data file; raises NativeBuildError when the
        library cannot be built and OSError when the file cannot be
        opened."""
        return cls(path, get_lib())

    def size(self) -> int:
        n = self._lib.ioeng_size(self._fd)
        if n < 0:
            raise OSError(-n, "ioeng_size")
        return int(n)

    def append(self, data: bytes) -> tuple[int, int]:
        """Append one blob; returns (file_offset, crc32c)."""
        buf = np.frombuffer(data, dtype=np.uint8)
        crc = ctypes.c_uint32(0)
        off = self._lib.ioeng_append(
            self._fd,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(data), 0, ctypes.byref(crc))
        if off < 0:
            raise OSError(-off, "ioeng_append")
        return int(off), int(crc.value)

    def read(self, off: int, length: int) -> tuple[bytes, int]:
        """pread one blob; returns (data, crc32c-of-data)."""
        out = np.empty(length, dtype=np.uint8)
        crc = ctypes.c_uint32(0)
        n = self._lib.ioeng_read(
            self._fd, off,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            length, 0, ctypes.byref(crc))
        if n < 0:
            raise OSError(-n, "ioeng_read")
        return out[:n].tobytes(), int(crc.value)

    def sync(self) -> None:
        from ceph_tpu_torch.utils import store_telemetry
        store_telemetry.timed_sync("blockstore.data", self._sync_raw)

    def _sync_raw(self) -> None:
        rc = self._lib.ioeng_sync(self._fd)
        if rc < 0:
            raise OSError(-rc, "ioeng_sync")

    def close(self) -> None:
        if self._fd >= 0:
            self._lib.ioeng_close(self._fd)
            self._fd = -1
