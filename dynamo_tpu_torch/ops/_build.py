"""Build the port's CUDA kernels with ``nvcc`` at first use and load them
with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface (pointers, ints, the
stream) and compiles on its own into ``build/dynamo_tpu_torch/lib<name>-
<hash>.so`` at the repository root, where ``<hash>`` covers the source
and the flags: an edited source rebuilds, an unchanged one loads the
library already there. No PyTorch headers are included, which keeps a
build to seconds. ``build_all`` starts one ``nvcc`` per source at once.

Nothing here runs at import: the module imports on machines without
``nvcc`` or a GPU, where only the kernels' plain versions are used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "dynamo_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
SOURCES = ("qmm", "paged_attention")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    """Start nvcc for one source unless its library is already built.
    Output goes to a temporary name and is renamed once complete."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    log = out.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
    return tmp, out, proc


def _finish(name: str, tmp: Path, out: Path, proc: subprocess.Popen) -> None:
    rc = proc.wait()
    log = out.with_suffix(".log")
    if rc != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (rc={rc}):\n{log.read_text()}"
        )
    os.replace(tmp, out)


def build_all(names: tuple[str, ...] = SOURCES) -> dict[str, str]:
    """Build every kernel library in parallel; returns {name: ptxas log}."""
    with _lock:
        started = {n: _start(n) for n in names}
        for n, job in started.items():
            if job is not None:
                _finish(n, *job)
    return {n: _target(n).with_suffix(".log").read_text()
            if _target(n).with_suffix(".log").exists() else ""
            for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, *job)
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
