"""Build and load the port's CUDA kernels.

Each ``vlsfr_tpu_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` into ``csrc/build/lib<name>-<hash>.so``
at first use (the hash is of the source and the shared ``csrc/*.cuh``
headers, so an edited kernel or header rebuilds), then loaded with
``ctypes``. Nothing here runs at import time; the CPU
tests never build anything.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
# csrc/<name>.cu, each its own library
SOURCES = ("quad_margin", "margin_ce", "conv3x3", "dot_probe")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LOADED: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def start_nvcc(src: Path, out: Path) -> subprocess.Popen:
    """An ``nvcc`` process building ``src`` (a .cu file; its quoted includes
    resolve beside it, then in ``csrc/``, so that an edited copy elsewhere
    builds against the shared headers) into the shared library ``out``."""
    return subprocess.Popen([find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every named source that is not built yet, one ``nvcc``
    process per source, all started together. Returns each new build's
    compiler output (the ``-Xptxas -v`` register/shared-memory report)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (start_nvcc(CSRC / f"{name}.cu", tmp), tmp, out)
    logs = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        logs[name] = log
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built on first use)."""
    if name not in _LOADED:
        build_all([name])
        _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return _LOADED[name]
