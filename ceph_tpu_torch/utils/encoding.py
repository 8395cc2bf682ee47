"""Versioned binary wire encoding — the src/include/encoding.h role.

The reference serializes every map/message/txn with ENCODE_START /
ENCODE_FINISH versioned sections and little-endian primitive encoders.
Same contract here: explicit little-endian primitives, length-prefixed
bytes/str, and versioned sections that let a decoder skip trailing
fields added by newer encoders (forward/backward compatibility —
encoding.h's compat_version semantics).

No pickle anywhere: wire bytes are data, never code.
"""

from __future__ import annotations

import struct


class Encoder:
    def __init__(self) -> None:
        self._parts: list[bytes] = []

    # primitives (little-endian, like encoding.h)
    def u8(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<B", v)); return self

    def u16(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<H", v)); return self

    def u32(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<I", v)); return self

    def u64(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<Q", v)); return self

    def i32(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<i", v)); return self

    def i64(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<q", v)); return self

    def f64(self, v: float) -> "Encoder":
        self._parts.append(struct.pack("<d", v)); return self

    def bool(self, v: bool) -> "Encoder":
        return self.u8(1 if v else 0)

    def bytes(self, v: bytes) -> "Encoder":
        self.u32(len(v)); self._parts.append(bytes(v)); return self

    def str(self, v: str) -> "Encoder":
        return self.bytes(v.encode())

    def list(self, vals, item_fn) -> "Encoder":
        self.u32(len(vals))
        for v in vals:
            item_fn(self, v)
        return self

    def map(self, d: dict, key_fn, val_fn) -> "Encoder":
        self.u32(len(d))
        for k in sorted(d):
            key_fn(self, k)
            val_fn(self, d[k])
        return self

    def str_map(self, d: dict) -> "Encoder":
        return self.map(d, Encoder.str, Encoder.str)

    def section(self, version: int, body: "Encoder",
                compat: int = 1) -> "Encoder":
        """ENCODE_START(version, compat, ...) ... ENCODE_FINISH:
        version + compat bytes + length-prefixed body. ``compat`` is the
        oldest decoder version able to read this encoding; decoders skip
        trailing bytes they don't parse."""
        payload = body.getvalue()
        self.u8(version)
        self.u8(compat)
        self.bytes(payload)
        return self

    # -- scatter-gather surface (ROADMAP 1c) --------------------------
    def raw(self, v: bytes) -> "Encoder":
        """Append pre-encoded bytes as their own part, by reference:
        ``getparts`` hands it through uncopied (length prefixes are
        the caller's job — pair with an explicit ``u32``)."""
        self._parts.append(v)
        return self

    def getparts(self) -> list[bytes]:
        """The encoded buffers WITHOUT the final join — the sendmsg-
        style scatter list whose concatenation == ``getvalue()``."""
        return list(self._parts)

    def nbytes(self) -> int:
        return sum(len(p) for p in self._parts)

    def getvalue(self) -> bytes:
        return b"".join(self._parts)


class DecodeError(Exception):
    pass


class Decoder:
    def __init__(self, buf: bytes, off: int = 0) -> None:
        self._buf = buf
        self._off = off

    def _take(self, n: int) -> bytes:
        if self._off + n > len(self._buf):
            raise DecodeError(
                f"short buffer: need {n} at {self._off}, have {len(self._buf)}")
        v = self._buf[self._off:self._off + n]
        self._off += n
        return v

    def u8(self) -> int: return struct.unpack("<B", self._take(1))[0]
    def u16(self) -> int: return struct.unpack("<H", self._take(2))[0]
    def u32(self) -> int: return struct.unpack("<I", self._take(4))[0]
    def u64(self) -> int: return struct.unpack("<Q", self._take(8))[0]
    def i32(self) -> int: return struct.unpack("<i", self._take(4))[0]
    def i64(self) -> int: return struct.unpack("<q", self._take(8))[0]
    def f64(self) -> float: return struct.unpack("<d", self._take(8))[0]
    def bool(self) -> bool: return self.u8() != 0

    def bytes(self) -> bytes:
        return self._take(self.u32())

    def str(self) -> str:
        return self.bytes().decode()

    def list(self, item_fn) -> list:
        return [item_fn(self) for _ in range(self.u32())]

    def map(self, key_fn, val_fn) -> dict:
        n = self.u32()
        return {key_fn(self): val_fn(self) for _ in range(n)}

    def str_map(self) -> dict:
        return self.map(Decoder.str, Decoder.str)

    def section(self, max_supported: int) -> tuple[int, "Decoder"]:
        """DECODE_START: returns (version, sub-decoder over the section
        body). A newer encoding is readable as long as its ``compat``
        floor is within what this reader supports (the known field
        prefix decodes; unknown trailing bytes are skipped). Raises
        DecodeError when the encoder declared itself incompatible."""
        version = self.u8()
        compat = self.u8()
        body = self.bytes()
        if compat > max_supported:
            raise DecodeError(
                f"encoding v{version} requires decoder >= v{compat}, "
                f"this reader supports <= v{max_supported}")
        return version, Decoder(body)

    def remaining(self) -> int:
        return len(self._buf) - self._off

    def eof(self) -> bool:
        return self._off >= len(self._buf)
