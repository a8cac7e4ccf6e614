"""Builds and loads the package's CUDA kernels at first use.

Every source under ``csrc/`` has a plain C interface (no PyTorch headers),
so ``nvcc`` compiles it in seconds into a shared library of its own that is
loaded with ``ctypes``; the sources compile concurrently, one ``nvcc``
process each. Libraries land in ``build/repro_torch_kernels/`` under the
checkout root (override with ``REPRO_TORCH_BUILD_DIR``) and are reused
while source and flags are unchanged. Nothing here runs at import: the
first kernel launch (or :func:`load`) triggers the build, and a failure to
find ``nvcc``, to compile or to load raises — there is no fallback.
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

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("gbatc_kernels.cu", "flash_attention.cu", "block_quant.cu",
           "rglru_scan.cu", "rwkv6_scan.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_INFO: dict = {}


class KernelCompileError(RuntimeError):
    """The CUDA kernels could not be compiled or loaded."""


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def find_nvcc() -> str:
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(Path(os.environ[var]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise KernelCompileError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the CUDA kernels cannot be built on this machine"
    )


def _stamp(src: Path) -> str:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def load() -> dict[str, ctypes.CDLL]:
    """Compile (if stale) and load every kernel library; returns them by
    source stem. Idempotent and thread-safe."""
    with _LOCK:
        if _LIBS:
            return _LIBS
        t0 = time.perf_counter()
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        jobs = []
        for name in SOURCES:
            src = CSRC / name
            lib = out_dir / f"lib{src.stem}.so"
            stamp_file = out_dir / f"{src.stem}.stamp"
            stamp = _stamp(src)
            fresh = (
                lib.is_file() and stamp_file.is_file()
                and stamp_file.read_text() == stamp
            )
            proc = None
            if not fresh:
                cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)]
                proc = subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                )
            jobs.append((src, lib, stamp_file, stamp, proc))
        compiled = []
        for src, lib, stamp_file, stamp, proc in jobs:
            if proc is not None:
                log, _ = proc.communicate()
                (out_dir / f"{src.stem}.log").write_text(log)
                if proc.returncode != 0:
                    raise KernelCompileError(
                        f"nvcc failed on {src.name} "
                        f"(exit {proc.returncode}):\n{log}"
                    )
                stamp_file.write_text(stamp)
                compiled.append(src.name)
            try:
                _LIBS[src.stem] = ctypes.CDLL(str(lib))
            except OSError as e:
                _LIBS.clear()
                raise KernelCompileError(f"cannot load {lib}: {e}") from e
        _INFO.update(
            seconds=time.perf_counter() - t0,
            compiled=compiled,
            build_dir=str(out_dir),
        )
        return _LIBS


def build_info() -> dict:
    """Seconds the last :func:`load` took, which sources it compiled, and
    where; empty before the first load."""
    return dict(_INFO)


def build_log(stem: str) -> str:
    """Compiler output of the last build of ``stem`` (register and shared
    memory use per kernel, from ``-Xptxas -v``)."""
    path = build_dir() / f"{stem}.log"
    return path.read_text() if path.is_file() else ""
