"""The kernel build ledger: which kernel libraries a process found built.

Port of ``ceph_tpu/utils/compile_cache.py``. The reference points JAX's
persistent compilation cache at a repo-local directory and keeps a
per-signature ledger beside it, so a warm run can prove that it compiled
nothing. The port's kernels are ``nvcc``-built libraries, already named
by a hash of source and flags (``ops/cuda_build.py``) and so already
persistent across processes of one checkout; what is left of the module
is the ledger:

- ``enable()``: point the ledger at a directory (default the kernel
  build directory, ``build/torch_ext/``; ``CEPH_TPU_COMPILE_CACHE_DIR``
  overrides) and load what earlier processes recorded. Idempotent;
  called on the first kernel build or load (the reference's engine
  enables its cache at construction; here nothing needs it earlier).
- ``note_build(name, library, seconds)``: called once per kernel library
  a process loads. ``seconds`` None means the library was on disk (a
  ``compile_cache_hits`` on the device telemetry); a number is the wall
  time of the ``nvcc`` run this process made (a ``compile_cache_misses``).
  The ledger file (``builds.json`` in the directory) keeps, per library,
  the first build's wall (``cold_s``), the builds and the hits.

``CEPH_TPU_COMPILE_CACHE=0`` turns off the ledger only: libraries are
found and built exactly as without it. The ledger is advisory
(best-effort I/O): a read-only checkout loses the file, not a build.
"""

from __future__ import annotations

import json
import os
import threading

#: ledger file inside the ledger directory
LEDGER_NAME = "builds.json"

_lock = threading.Lock()
_enabled_dir: str | None = None
#: library file name -> entry, as loaded from disk and updated since
_entries: dict[str, dict] = {}
#: kernel names this process has already accounted (one count each)
_seen: set[str] = set()


def default_dir() -> str:
    """The kernel build directory (``build/torch_ext/`` at the repository
    root), or ``CEPH_TPU_COMPILE_CACHE_DIR``."""
    env = os.environ.get("CEPH_TPU_COMPILE_CACHE_DIR")
    if env:
        return env
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(pkg_root, "build", "torch_ext")


def disabled() -> bool:
    return os.environ.get("CEPH_TPU_COMPILE_CACHE", "1").lower() in (
        "0", "no", "off", "false")


def enable(cache_dir: str | None = None) -> str | None:
    """Turn the ledger on; returns its directory (None when disabled
    via env). A second call with the same or no directory is a no-op."""
    global _enabled_dir
    if disabled():
        return None
    with _lock:
        if _enabled_dir is not None and cache_dir in (None,
                                                      _enabled_dir):
            return _enabled_dir
        cache_dir = cache_dir or default_dir()
        _enabled_dir = cache_dir
        _entries.clear()
        _entries.update(_load_ledger(cache_dir))
        _seen.clear()
        return cache_dir


def enabled_dir() -> str | None:
    return _enabled_dir


def _ledger_path(cache_dir: str) -> str:
    return os.path.join(cache_dir, LEDGER_NAME)


def _load_ledger(cache_dir: str) -> dict:
    try:
        with open(_ledger_path(cache_dir)) as f:
            out = json.load(f)
            return out if isinstance(out, dict) else {}
    except (OSError, ValueError):
        return {}


def _persist_locked() -> None:
    assert _enabled_dir is not None
    try:
        os.makedirs(_enabled_dir, exist_ok=True)
        tmp = _ledger_path(_enabled_dir) + f".{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(_entries, f, indent=1, sort_keys=True)
        os.replace(tmp, _ledger_path(_enabled_dir))
    except OSError:
        pass                       # read-only checkout: ledger skipped


def note_build(name: str, library: str,
               seconds: float | None) -> bool | None:
    """Account kernel ``name``'s library ``library`` (a file name) once
    per process: a hit when ``seconds`` is None (found built), else a
    miss with the ``nvcc`` wall. Returns True for a hit, False for a
    miss, None when the ledger is off or ``name`` was already
    accounted by this process."""
    if enable() is None:
        return None
    with _lock:
        if name in _seen:
            return None
        _seen.add(name)
        ent = _entries.setdefault(library, {"kernel": name})
        if seconds is None:
            ent["hits"] = int(ent.get("hits", 0)) + 1
        else:
            ent["builds"] = int(ent.get("builds", 0)) + 1
            ent.setdefault("cold_s", round(seconds, 4))
        _persist_locked()
    from ceph_tpu_torch.utils.device_telemetry import telemetry
    telemetry().perf.inc("compile_cache_hits" if seconds is None
                         else "compile_cache_misses")
    return seconds is None


def ledger() -> dict:
    """{library: {kernel, cold_s?, builds?, hits?}} as on disk plus
    this process's updates."""
    with _lock:
        return {lib: dict(ent) for lib, ent in _entries.items()}


def _reset_for_tests() -> None:
    """Drop the enabled state so a test can re-enable from a fresh dir
    (simulates a new process against the same build directory)."""
    global _enabled_dir
    with _lock:
        _enabled_dir = None
        _entries.clear()
        _seen.clear()
