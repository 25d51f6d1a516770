"""ctypes binding of the native batch image decoder (``loader.cpp``): the
port of eoe_tpu/native/__init__.py.

The library is built at first use with ``g++ -O3`` against the system's
libjpeg and libpng into ``eoe_tpu_torch/_build/`` (named by a hash of the
source and the flags), never at import. Where the compiler or the libraries
are missing, ``get_lib`` returns None and ``FolderSource`` decodes with PIL,
as the JAX package does; an image the library fails on is decoded with PIL
too. ``EOE_TPU_NATIVE=0`` turns the library off. This is host code, not a
kernel of the card.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
LIBS = ("-ljpeg", "-lpng")

_lib = None
_lock = threading.Lock()
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"loader-{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), *LIBS, "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on the first call; None when unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("EOE_TPU_NATIVE", "1") == "0":
            return None
        out = library_path()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
            lib.eoe_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            lib.eoe_decode_batch.restype = None
            lib.eoe_loader_version.argtypes = []
            lib.eoe_loader_version.restype = ctypes.c_int
            if lib.eoe_loader_version() != 1:
                return None
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def decode_batch(paths: List[str], hw, channels: int, n_threads: int = 16
                 ) -> Optional[np.ndarray]:
    """Decode a batch into (n, h, w, c) uint8; None when the library is
    unavailable or any image failed (see ``decode_batch_with_status``)."""
    out, status = decode_batch_with_status(paths, hw, channels, n_threads)
    if out is None or status.any():
        return None
    return out


def decode_batch_with_status(paths: List[str], hw, channels: int, n_threads: int = 16):
    """(images, status): status[i] is nonzero where image i failed to decode;
    (None, None) when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None, None
    n = len(paths)
    out = np.empty((n, hw[0], hw[1], channels), dtype=np.uint8)
    status = np.zeros(n, dtype=np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.eoe_decode_batch(
        c_paths, n, int(hw[0]), int(hw[1]), int(channels),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(n_threads), status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out, status
