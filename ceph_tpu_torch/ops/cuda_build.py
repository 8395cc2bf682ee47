"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
one ``nvcc`` per source builds in seconds; :func:`build_all` starts them
all at once. Libraries land in ``build/torch_ext/`` at the repository
root, named by a hash of source and flags, so an unchanged kernel is not
rebuilt within one checkout. Nothing is built at import time: the first
launch (or :func:`build_all`) builds. The build ledger
(``utils/compile_cache``) records, once a process, each library found
built or built with its ``nvcc`` wall.

A missing ``nvcc`` or a failed build raises :class:`KernelBuildError` —
there is no fallback to the plain torch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"

#: Hopper only: ``sm_90a`` keeps wgmma/setmaxnreg available to later kernels
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: seconds all nvcc processes of one build_all may take together
BUILD_TIMEOUT_S = 600.0

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for cand in cands:
        if cand and Path(cand).is_file():
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME)")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (process or None, library path, temporary output path)."""
    out = _lib_path(name)
    if out.exists():
        return None, out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out, tmp


def build_all(names) -> dict[str, str]:
    """Build every named kernel, all nvcc processes in parallel.
    Returns name -> compiler output (ptxas register/shared-memory
    report); raises KernelBuildError if any build fails."""
    from ceph_tpu_torch.utils import compile_cache
    with _lock:
        t0 = time.monotonic()
        started = {name: _start(name) for name in names}
        logs, failed = {}, []
        deadline = t0 + BUILD_TIMEOUT_S
        for name, (proc, out, tmp) in started.items():
            if proc is None:
                logs[name] = "(cached)"
                compile_cache.note_build(name, out.name, None)
                continue
            try:
                log, _ = proc.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                proc.kill()
                log, _ = proc.communicate()
                failed.append(f"{name}: nvcc timed out")
                continue
            logs[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            else:
                os.replace(tmp, out)
                compile_cache.note_build(name, out.name,
                                         time.monotonic() - t0)
        if failed:
            raise KernelBuildError("\n".join(failed))
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, building it on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib


class DeviceArrays:
    """A kernel's host tables (numpy), uploaded once per device."""

    def __init__(self, arrays: dict) -> None:
        self.arrays = arrays
        self._lock = threading.Lock()
        self._dev: dict[str, dict] = {}

    def on(self, device) -> dict:
        """name -> tensor on ``device`` for every numpy array."""
        key = str(device)
        with self._lock:
            dev = self._dev.get(key)
            if dev is None:
                dev = self._dev[key] = {
                    name: torch.from_numpy(np.ascontiguousarray(arr)).to(
                        device)
                    for name, arr in self.arrays.items()
                    if isinstance(arr, np.ndarray)}
        return dev


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by one of ``lib``'s
    launchers (every library exports ``error_string``)."""
    if err:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        msg = lib.error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
