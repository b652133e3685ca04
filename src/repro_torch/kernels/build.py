"""Build the port's CUDA kernels from ``src/repro_torch/csrc`` at first use.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  All sources
compile at once, one ``nvcc`` process each.  The libraries land in
``build/repro_torch/<hash>/`` at the repository root, keyed by a hash of
every source and the compiler flags, so an edited source rebuilds and an
unchanged one loads the library it built before.

Nothing here runs at import time: the CPU tests import every module of the
port, and this machine-independent code only reaches ``nvcc`` when a
kernel wrapper first sees a CUDA tensor (or a caller asks for the build).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class LaunchCount:
    """Launches of one CUDA kernel since the count was last set to 0."""
    n: int = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built from source on a machine with the CUDA toolkit")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, str]:
    """Compile every ``csrc/*.cu`` that is not built yet, all in parallel.

    Returns ``{source name: nvcc's report}`` for the sources compiled by
    this call (empty when every library was already built).  Raises
    ``RuntimeError`` with the compiler's output if any compile fails.
    """
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sorted(CSRC.glob("*.cu")):
        lib = out_dir / f"lib{src.stem}.so"
        if lib.exists():
            continue
        tmp = out_dir / f"lib{src.stem}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib)
    reports, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _LIBS:
        lib = _build_dir() / f"lib{name}.so"
        if not lib.exists():
            build_all()
        _LIBS[name] = ctypes.CDLL(str(lib))
    return _LIBS[name]

