"""Builds the port's CUDA sources into shared libraries and loads them.

Each source under ``eoe_tpu_torch/csrc`` exposes a plain ``extern "C"``
launcher (data pointers, sizes, the CUDA stream), so one ``nvcc`` call per
source builds it in seconds: no PyTorch headers, no ``ninja``. The library is
loaded with ``ctypes``. Builds are cached under ``eoe_tpu_torch/_build`` by a
hash of the source and the flags, and happen at first use, never at import.
A failed build raises :class:`BuildError`; nothing falls back to the plain
PyTorch versions.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# sm_90a, not sm_90: wgmma and setmaxnreg exist only for the "a" target
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


class BuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise BuildError("nvcc not found (looked on PATH, in $CUDA_HOME/bin and "
                     "/usr/local/cuda/bin); the port's kernels need the CUDA toolkit")


def library_path(source: str) -> Path:
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless a library for its current content
    exists. The compiler's report (registers, shared memory, spills) is kept
    beside the library as ``.log``."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise BuildError(f"nvcc failed for {source} (exit {proc.returncode}):\n"
                         f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_log(source: str) -> str:
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(source: str) -> ctypes.CDLL:
    """Build ``source`` if needed and load it; callers cache the library."""
    return ctypes.CDLL(str(build(source)))
