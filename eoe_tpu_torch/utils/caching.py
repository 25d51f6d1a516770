"""POSIX shared-memory image cache codec: the port of eoe_tpu/utils/caching.py.

A long-running cache server decodes and resizes a dataset once and publishes
each image as a named shared-memory block ``{ds}_{split}_{idx}``: a 15-byte
header of three 5-digit ASCII dimensions followed by the flat uint8 image.
Training processes attach read-only (``FolderSource(shm_prefix=...)``). A
reader unregisters each block from its resource tracker after closing it, so
that its exit does not reclaim the server's memory.
"""

from multiprocessing import shared_memory
from typing import Optional

import numpy as np

HEADER = 15  # 3 x 5-digit ascii dims


def encode_shape_and_image(img: np.ndarray) -> np.ndarray:
    """uint8 image (h, w, c) -> flat uint8 buffer with a 15-byte shape header."""
    assert img.ndim == 3 and img.dtype == np.uint8
    header = "".join(f"{d:05d}" for d in img.shape).encode("ascii")
    return np.concatenate([np.frombuffer(header, np.uint8), img.reshape(-1)])


def decode_shape_and_image(buf: np.ndarray) -> np.ndarray:
    """Inverse of :func:`encode_shape_and_image`."""
    header = bytes(buf[:HEADER].tolist()).decode("ascii")
    shape = tuple(int(header[i * 5:(i + 1) * 5]) for i in range(3))
    return buf[HEADER:HEADER + int(np.prod(shape))].reshape(shape)


def write_shm_image(name: str, img: np.ndarray) -> int:
    """Publish one encoded image as a named block; returns its byte size. The
    block outlives this function until :func:`unlink_shm_image`."""
    data = encode_shape_and_image(np.ascontiguousarray(img))
    try:
        shm = shared_memory.SharedMemory(name=name, create=True, size=data.nbytes)
    except FileExistsError:
        old = shared_memory.SharedMemory(name=name)
        old.close()
        old.unlink()
        shm = shared_memory.SharedMemory(name=name, create=True, size=data.nbytes)
    shm.buf[:data.nbytes] = data.tobytes()
    shm.close()
    return data.nbytes


def read_shm_image(name: str) -> Optional[np.ndarray]:
    """Attach to a published block and decode it; None if it is absent. The
    block is unregistered from this process's resource tracker, so closing
    it leaves the server's memory alone."""
    try:
        shm = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return None
    try:
        img = decode_shape_and_image(np.copy(np.frombuffer(shm.buf, np.uint8)))
    finally:
        shm.close()
        try:
            from multiprocessing.resource_tracker import unregister
            unregister(shm._name, "shared_memory")  # noqa: SLF001
        except Exception:
            pass
    return img


def unlink_shm_image(name: str) -> bool:
    try:
        shm = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return False
    shm.close()
    try:
        shm.unlink()
    except FileNotFoundError:
        return False
    return True
