"""Run logger: the on-disk output contract of eoe_tpu/utils/logger.py.

A run directory ``log_{YYYYMMDDHHMMSS}_{comment}`` holds
  print.txt / logtxt.txt / warnings.txt   -- text streams
  setup.json, setup_v1.json               -- the serialized configuration
  src.tar.gz                              -- the port's source, for provenance
  results.json, eval_cls{i}_it{j}_anomaly_scores.json -- metrics
  scalars.json                            -- scalars and histograms
  *.pdf                                   -- ROC/PRC curves with mean curves
  *.png                                   -- image grids (previews, OE samples)
  snapshots/snapshot_cls{i}_it{j}.pt      -- model + optimizer + epoch + stats

Snapshots are ``torch.save`` files that ``torch.load(..., weights_only=True)``
reads, as ``inference.AnomalyScorer`` does. PDFs are drawn only where
matplotlib imports; the logger says so once in print.txt where it does not.
There is no tensorboard writer: scalars go to scalars.json. Image grids are
the JAX package's (``logimg``: 2-pixel gutters, ``nrow`` columns, row
headers drawn with PIL); they are written only where PIL imports. Writes
happen inline, so ``drain()`` has nothing to wait for; it is kept for the
JAX package's API.
"""

import json
import os
import os.path as pt
import tarfile
from datetime import datetime
from typing import List, Optional, Sequence

import numpy as np
import torch

from eoe_tpu_torch.ops.metrics import PRC, ROC


class JsonEncoder(json.JSONEncoder):
    def default(self, o):
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, torch.Tensor):
            return o.detach().cpu().tolist()
        if isinstance(o, (set, tuple)):
            return list(o)
        if isinstance(o, torch.dtype):
            return str(o).replace("torch.", "")
        return repr(o)


def mean_roc(rocs: Sequence[ROC], n_points: int = 200) -> Optional[ROC]:
    """Average ROC curves on a common FPR grid."""
    rocs = [r for r in rocs if r is not None]
    if not rocs:
        return None
    grid = np.linspace(0, 1, n_points)
    mean_tpr = np.mean([np.interp(grid, r.fpr, r.tpr) for r in rocs], axis=0)
    return ROC(tpr=mean_tpr, fpr=grid, thresholds=np.full(n_points, np.nan),
               auc=float(np.mean([r.auc for r in rocs])))


class _MeanROC(ROC):
    """ROC with the seed-wise AUC std attached."""
    def __new__(cls, tpr, fpr, thresholds, auc, std=0.0):
        return super().__new__(cls, tpr, fpr, thresholds, auc)

    def __init__(self, tpr, fpr, thresholds, auc, std=0.0):
        self.std = std


class _MeanPRC(PRC):
    def __new__(cls, prec, rec, thresholds, avg_prec, std=0.0):
        return super().__new__(cls, prec, rec, thresholds, avg_prec)

    def __init__(self, prec, rec, thresholds, avg_prec, std=0.0):
        self.std = std


class Logger:
    def __init__(self, logdir: str, comment: str = "", noname: bool = False,
                 active: bool = True, archive_source: bool = True):
        """
        @param logdir: parent directory of the run directories.
        @param comment: appended to the timestamped run directory name.
        @param noname: use ``logdir`` itself as the run directory.
        @param active: an inactive logger writes nothing.
        """
        self.active = active
        self.start = datetime.now()
        if noname:
            self.dir = logdir
        else:
            name = f"log_{self.start.strftime('%Y%m%d%H%M%S')}{'_' + comment if comment else ''}"
            self.dir = pt.join(logdir, name)
        if self.active:
            os.makedirs(pt.join(self.dir, "snapshots"), exist_ok=True)
        self.comment = comment
        self._scalars = {}
        self._no_plots_said = False
        if archive_source and self.active:
            self.log_source_archive()

    def drain(self):
        """Writes are synchronous: nothing is pending when this returns."""

    # ---------------------------------------------------------- text

    def _append(self, fname: str, msg: str):
        if not self.active:
            return
        with open(pt.join(self.dir, fname), "a") as f:
            f.write(msg + "\n")

    def print(self, msg: str):
        print(msg)
        self._append("print.txt", str(msg))

    def logtxt(self, msg: str, print_msg: bool = True):
        if print_msg:
            print(msg)
        self._append("logtxt.txt", str(msg))

    def warning(self, msg: str, print_msg: bool = True):
        if print_msg:
            print(f"WARNING: {msg}")
        self._append("warnings.txt", str(msg))

    # ---------------------------------------------------------- json / setup

    def logjson(self, name: str, d: dict):
        if not self.active:
            return
        with open(pt.join(self.dir, f"{name}.json"), "w") as f:
            json.dump(d, f, indent=2, cls=JsonEncoder)

    def logsetup(self, setup: dict, step: int = 0):
        """setup.json (step 0) and setup_v{n}.json for later additions."""
        self.logjson("setup" if step == 0 else f"setup_v{step}", setup)

    def log_source_archive(self):
        """Archive the port's source tree for provenance."""
        try:
            src_root = pt.dirname(pt.dirname(pt.abspath(__file__)))
            out = pt.join(self.dir, "src.tar.gz")
            if not pt.exists(out):
                with tarfile.open(out, "w:gz") as tar:
                    tar.add(src_root, arcname=pt.basename(src_root),
                            filter=lambda ti: None if ("__pycache__" in ti.name
                                                       or "_build" in ti.name) else ti)
        except OSError as e:  # never fail a run over provenance
            self.warning(f"could not archive source: {e}", print_msg=False)

    # ---------------------------------------------------------- scalars

    def add_scalar(self, name: str, value: float, step: int):
        if self.active:
            self._scalars.setdefault(name, []).append((int(step), float(value)))

    def hist(self, name: str, values, step: int = 0, bins: int = 30):
        """A histogram as a JSON record in scalars.json."""
        if not self.active:
            return
        vals = np.asarray(values, np.float64).reshape(-1)
        vals = vals[np.isfinite(vals)]
        if vals.size == 0:
            return
        counts, edges = np.histogram(vals, bins=bins)
        self._scalars.setdefault(f"hist/{name}", []).append(
            (int(step), {"counts": counts.tolist(), "edges": edges.tolist()}))

    def flush_scalars(self):
        if self.active and self._scalars:
            with open(pt.join(self.dir, "scalars.json"), "w") as f:
                json.dump(self._scalars, f, cls=JsonEncoder)

    # ---------------------------------------------------------- images

    def logimg(self, name: str, images, nrow: int = 8, rowheaders: Optional[List[str]] = None):
        """Save an image grid as ``{name}.png`` with optional per-row header
        captions. ``images`` is (n, h, w, c), uint8 or float in [0, 1] (a
        numpy array or a tensor on any device)."""
        if not self.active:
            return
        try:
            import PIL  # noqa: F401
        except ImportError:
            return
        if isinstance(images, torch.Tensor):
            images = images.detach().cpu().numpy()
        imgs = np.asarray(images)
        if imgs.dtype != np.uint8:
            imgs = (np.clip(imgs, 0, 1) * 255).astype(np.uint8)
        self._render_img(name, imgs, nrow, rowheaders)

    def _render_img(self, name: str, imgs: np.ndarray, nrow: int,
                    rowheaders: Optional[List[str]]):
        from PIL import Image, ImageDraw
        n, h, w, c = imgs.shape
        nrows = int(np.ceil(n / nrow))
        header_w = max(10 * max(len(str(s)) for s in rowheaders) + 6, 40) if rowheaders else 0
        grid = np.zeros((nrows * (h + 2), header_w + nrow * (w + 2), c), dtype=np.uint8)
        for i in range(n):
            r, col = divmod(i, nrow)
            top, left = r * (h + 2) + 1, header_w + col * (w + 2) + 1
            grid[top:top + h, left:left + w] = imgs[i]
        img = Image.fromarray(grid[..., 0] if c == 1 else grid)
        if rowheaders:
            img = img.convert("RGB")
            draw = ImageDraw.Draw(img)
            for r, text in enumerate(rowheaders[:nrows]):
                draw.text((3, r * (h + 2) + max(h // 2 - 5, 0)), str(text), fill=(255, 255, 255))
        path = pt.join(self.dir, f"{name}.png")
        os.makedirs(pt.dirname(path), exist_ok=True)
        img.save(path, compress_level=1)   # the same pixels, encoded faster

    # ---------------------------------------------------------- curves

    def plot_many(self, curves: Sequence, labels: Optional[Sequence[str]] = None,
                  name: str = "roc", step: int = 0):
        """Plot ROC/PRC curves and their mean into ``{name}.pdf`` where
        matplotlib is installed; returns the mean curve with the seed-wise
        std attached."""
        curves = list(curves or [])
        kept = [c for c in curves if c is not None]
        if not kept:
            return None
        is_roc = isinstance(kept[0], ROC)
        mean = mean_roc(kept) if is_roc else None
        if self.active:
            self._plot(curves, kept, labels, name, is_roc, mean)
        if is_roc:
            return _MeanROC(mean.tpr, mean.fpr, mean.thresholds, mean.auc,
                            float(np.std([c.auc for c in kept])))
        aps = [c.avg_prec for c in kept]
        return _MeanPRC(kept[0].prec, kept[0].rec, kept[0].thresholds,
                        float(np.mean(aps)), float(np.std(aps)))

    def _plot(self, curves, kept, labels, name, is_roc, mean):
        try:
            from matplotlib.figure import Figure
        except ImportError:
            if not self._no_plots_said:
                self.print("matplotlib is not installed: ROC/PRC PDFs are not drawn")
                self._no_plots_said = True
            return
        labels = list(labels) if labels is not None else None
        fig = Figure(figsize=(5, 5))
        ax = fig.subplots()
        for i, cur in enumerate(curves):
            if cur is None:
                continue
            lbl = labels[i] if labels is not None and i < len(labels) else None
            if is_roc:
                ax.plot(cur.fpr, cur.tpr, alpha=0.4,
                        label=f"{lbl} ({cur.auc * 100:.1f}%)" if lbl else None)
            else:
                ax.plot(cur.rec, cur.prec, alpha=0.4,
                        label=f"{lbl} ({cur.avg_prec * 100:.1f}%)" if lbl else None)
        if is_roc and mean is not None and len(kept) > 1:
            ax.plot(mean.fpr, mean.tpr, "k-", label=f"mean ({mean.auc * 100:.1f}%)")
        ax.set_xlabel("FPR" if is_roc else "Recall")
        ax.set_ylabel("TPR" if is_roc else "Precision")
        if labels is not None or len(kept) > 1:
            ax.legend(fontsize=6)
        fig.savefig(pt.join(self.dir, f"{name}.pdf"), bbox_inches="tight")

    # ---------------------------------------------------------- snapshots

    def snapshot_path(self, name: str) -> str:
        return pt.join(self.dir, "snapshots", f"{name}.pt")

    def snapshot(self, name: str, payload: dict) -> str:
        """``torch.save`` {'params', 'opt_state', 'epoch', 'ds_statistics',
        'setup'}; tensors should be on the CPU."""
        if not self.active:
            return ""
        path = self.snapshot_path(name)
        torch.save(payload, path)
        return path
