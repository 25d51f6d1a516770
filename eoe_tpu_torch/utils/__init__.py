"""Utilities of the port: the run logger and ``imshow``."""

from typing import Optional

import numpy as np


def imshow(images, nrow: int = 8, path: Optional[str] = None, norm: bool = True):
    """An image grid for debugging: ``images`` (n, h, w, c) or (h, w, c),
    uint8 or float (a numpy array or a tensor on any device; floats are
    min-max normalised over the whole batch with ``norm``, then clipped to
    [0, 1]), ``nrow`` columns without gutters. Written to ``path`` as a PNG
    (returned), else shown through matplotlib's pyplot, which needs a
    display."""
    if hasattr(images, "detach"):
        images = images.detach().cpu().numpy()
    imgs = np.asarray(images)
    if imgs.ndim == 3:
        imgs = imgs[None]
    if imgs.dtype != np.uint8:
        if norm:
            lo, hi = imgs.min(), imgs.max()
            imgs = (imgs - lo) / max(hi - lo, 1e-9)
        imgs = (np.clip(imgs, 0, 1) * 255).astype(np.uint8)
    n, h, w, c = imgs.shape
    rows = int(np.ceil(n / nrow))
    grid = np.zeros((rows * h, nrow * w, c), np.uint8)
    for i in range(n):
        r, col = divmod(i, nrow)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = imgs[i]
    grid = grid if c == 3 else grid[..., 0]
    if path is not None:
        from PIL import Image
        Image.fromarray(grid).save(path)
        return path
    import matplotlib.pyplot as plt
    plt.figure(figsize=(nrow, rows))
    plt.imshow(grid, cmap=None if c == 3 else "gray")
    plt.axis("off")
    plt.show()
    return None
