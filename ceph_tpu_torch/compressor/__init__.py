"""Compression plugin layer (src/compressor/ role).

Port of ``ceph_tpu/compressor/__init__.py``. The reference registers
compressor plugins (zlib/snappy/zstd/lz4/brotli + QAT offload) through the
same dlopen pattern as the EC plugins (CompressionPlugin registry). Here
plugins self-register in a process registry; as in the reference, a codec
registers only if it can be imported (the plugin-missing path behaves like
the reference's failed dlopen), and snappy (where python-snappy is absent)
and lz4block run in the port's host native library
(``ops/native_loader.py``), which builds on first use of either codec and
raises if it cannot.

BlueStore-role usage: ``Compressor.create(name)`` then
``compress()/decompress()``; compressed blobs record the plugin id so
reads pick the right decompressor (bluestore_compression_algorithm). The
bytes equal the reference's for every codec both packages register.
"""

from __future__ import annotations

import threading
from typing import Callable

from ceph_tpu_torch.ops import native_loader as _nl

__all__ = ["Compressor", "CompressionPluginRegistry", "registry"]


class CompressionError(Exception):
    pass


class Compressor:
    """One codec instance (CompressionPlugin::compressor role)."""

    def __init__(self, name: str,
                 compress: Callable[[bytes], bytes],
                 decompress: Callable[[bytes], bytes]) -> None:
        self.name = name
        self._c = compress
        self._d = decompress

    def compress(self, data: bytes) -> bytes:
        return self._c(bytes(data))

    def decompress(self, data: bytes) -> bytes:
        return self._d(bytes(data))

    @classmethod
    def create(cls, name: str) -> "Compressor":
        return registry().create(name)


class CompressionPluginRegistry:
    """Singleton registry (same shape as ErasureCodePluginRegistry)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._plugins: dict[str, tuple[Callable, Callable]] = {}

    def register(self, name: str, compress, decompress) -> None:
        with self._lock:
            self._plugins[name] = (compress, decompress)

    def plugins(self) -> list[str]:
        with self._lock:
            return sorted(self._plugins)

    def create(self, name: str) -> Compressor:
        with self._lock:
            entry = self._plugins.get(name)
        if entry is None:
            raise CompressionError(
                f"no compressor plugin {name!r} "
                f"(have {self.plugins()})")
        return Compressor(name, *entry)


_registry = CompressionPluginRegistry()


def registry() -> CompressionPluginRegistry:
    return _registry


def _probe() -> None:
    import zlib
    _registry.register(
        "zlib", lambda d: zlib.compress(d, 6), zlib.decompress)

    import bz2
    _registry.register("bz2", bz2.compress, bz2.decompress)

    import lzma
    _registry.register("lzma", lzma.compress, lzma.decompress)

    try:
        import zstandard
        _c = zstandard.ZstdCompressor()
        _registry.register(
            "zstd", _c.compress,
            lambda d: zstandard.ZstdDecompressor().decompress(d))
    except ImportError:  # pragma: no cover
        pass
    try:
        import snappy
        _registry.register("snappy", snappy.compress, snappy.decompress)
    except ImportError:
        # the NATIVE snappy (native/lzcodecs.cc, from the format spec —
        # the reference vendors libsnappy the same way)
        _registry.register("snappy", _nl.snappy_compress,
                           _nl.snappy_decompress)
    try:
        import lz4.frame as _lz4
        _registry.register("lz4", _lz4.compress, _lz4.decompress)
    except ImportError:
        # 'lz4' means the LZ4 FRAME format only. The native block
        # codec below is a DIFFERENT wire format (u32 raw-length
        # prefix + LZ4 block) and registers under its own name (and
        # blockstore comp id), so a blob written without python-lz4
        # never gets misparsed as a frame after installing it (and
        # vice versa).
        pass

    # LZ4 block + u32 length prefix (the block format carries no raw
    # length; the reference's compressor framing records it the same way)
    def _lz4_c(d: bytes) -> bytes:
        return len(d).to_bytes(4, "little") + _nl.lz4_compress(d)

    def _lz4_d(d: bytes) -> bytes:
        raw_len = int.from_bytes(d[:4], "little")
        # the prefix is blob data (possibly corrupt): clamp against
        # LZ4's max expansion (255x) BEFORE allocating the output
        # buffer, or a flipped prefix commits GiBs
        if raw_len > max(len(d) * 255, 1 << 16):
            raise CompressionError(
                "corrupt lz4 blob: implausible raw length")
        return _nl.lz4_decompress(d[4:], raw_len)

    _registry.register("lz4block", _lz4_c, _lz4_d)


_probe()
