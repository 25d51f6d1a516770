"""Run logger: the on-disk output contract of eoe_tpu/utils/logger.py.

A run directory ``log_{YYYYMMDDHHMMSS}_{comment}`` holds
  print.txt / logtxt.txt / warnings.txt   -- text streams
  setup.json, setup_v1.json               -- the serialized configuration
  src.tar.gz                              -- the port's source, for provenance
  results.json, eval_cls{i}_it{j}_anomaly_scores.json -- metrics
  scalars.json                            -- scalars and histograms
  tb/events.out.tfevents.*                -- the same as tensorboard events
  *.pdf                                   -- ROC/PRC curves with mean curves
  *.png                                   -- image grids (previews, OE samples)
  snapshots/snapshot_cls{i}_it{j}.pt      -- model + optimizer + epoch + stats

Snapshots are ``torch.save`` files that ``torch.load(..., weights_only=True)``
reads, as ``inference.AnomalyScorer`` does. PDFs are drawn only where
matplotlib imports; the logger says so once in print.txt where it does not.
The tensorboard writer is on by default (``tensorboard=True``), as in the
JAX package: ``torch.utils.tensorboard.SummaryWriter`` into ``tb/`` takes
every scalar and histogram beside the JSON records; where it does not import
(no tensorboard package) the logger falls back silently to scalars.json
alone. ``flush_scalars`` flushes it, ``close`` closes it. Image grids are
the JAX package's (``logimg``: 2-pixel gutters, ``nrow`` columns, row
headers drawn with PIL); they are written only where PIL imports.

Image grids, ``plot_many``'s PDFs and snapshots are rendered and written on
one background thread that every logger shares (``_io_pool``), as in the
JAX package, so that the card trains the next seed while the host writes;
text, JSON and scalars are written inline. ``drain()`` blocks until every
write queued so far is on disk (``Trainer.run`` and its loads call it), and
writes may be queued again after it. ``EOE_TPU_SYNC_IO=1`` (read when a
logger is built) writes inline. A write that fails becomes a line of
warnings.txt, never an exception. ``timeit`` times a block into print.txt,
``track`` renders nested-loop progress with smoothed metrics (``Timer``,
``Tracker``).
"""

import json
import os
import os.path as pt
import tarfile
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from eoe_tpu_torch.ops.metrics import PRC, ROC

# one background writer shared by every Logger: a single thread keeps writes
# of one name in order and bounds the threads of many-run processes (the GA,
# the tests); concurrent.futures joins its queue at interpreter exit
_IO_POOL: Optional[ThreadPoolExecutor] = None


def _io_pool() -> ThreadPoolExecutor:
    global _IO_POOL
    if _IO_POOL is None:
        _IO_POOL = ThreadPoolExecutor(max_workers=1, thread_name_prefix="eoe-logger-io")
    return _IO_POOL


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


class Timer:
    """``with logger.timeit(name):`` prints "{name} took {s:.3f}s"."""

    def __init__(self, logger, name):
        self.logger, self.name = logger, name

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *a):
        self.logger.print(f"{self.name} took {time.time() - self.t0:.3f}s")


class Tracker:
    """Nested-loop progress with smoothed live metrics: ``update`` takes one
    increment per level (an outer tick resets the inner counts) and renders
    "desc i/n j/m | k=v ..." at most every ``print_every`` seconds; each
    metric is a callable whose finite numbers are smoothed exponentially."""

    def __init__(self, logger, totals: Sequence[int], metrics: Optional[dict] = None,
                 desc: str = "", smooth: float = 0.9, print_every: float = 0.5):
        self.logger = logger
        self.totals = list(totals)
        self.counts = [0] * len(totals)
        self.metrics = metrics or {}
        self.desc = desc
        self.smooth = smooth
        self._smoothed = {}
        self._last_print = 0.0
        self.print_every = print_every
        self.n = 0   # inner updates in all

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self._render(force=True)

    def update(self, increments: Sequence[int]):
        for i, inc in enumerate(increments):
            self.counts[i] += inc
            if inc and i < len(self.counts) - 1:
                for j in range(i + 1, len(self.counts)):
                    self.counts[j] = 0
        self.n += increments[-1] if increments else 0
        for k, fn in self.metrics.items():
            try:
                v = fn()
            except Exception:   # a metric that cannot be read yet is left out
                v = None
            if isinstance(v, (int, float)) and np.isfinite(v):
                prev = self._smoothed.get(k)
                self._smoothed[k] = v if prev is None else \
                    self.smooth * prev + (1 - self.smooth) * v
            elif v is not None:
                self._smoothed[k] = v
        self._render()

    def _render(self, force: bool = False):
        now = time.time()
        if not force and now - self._last_print < self.print_every:
            return
        self._last_print = now
        pos = " ".join(f"{c}/{t}" for c, t in zip(self.counts, self.totals))
        mets = " | ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                          for k, v in self._smoothed.items() if v is not None)
        print(f"\r{self.desc} {pos} {('| ' + mets) if mets else ''}",
              end="" if not force else "\n", flush=True)


class Logger:
    def __init__(self, logdir: str, comment: str = "", noname: bool = False,
                 active: bool = True, tensorboard: bool = True, archive_source: bool = True):
        """
        @param logdir: parent directory of the run directories.
        @param comment: appended to the timestamped run directory name.
        @param noname: use ``logdir`` itself as the run directory.
        @param active: an inactive logger writes nothing.
        @param tensorboard: write tensorboard events into ``tb/`` where
            ``torch.utils.tensorboard`` imports.
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
        self.tb_writer = None
        if tensorboard and self.active:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb_writer = SummaryWriter(log_dir=pt.join(self.dir, "tb"))
            except Exception:   # no tensorboard package: scalars.json alone
                self.tb_writer = None
        self._io_pending: list = []
        self._io_sync = os.environ.get("EOE_TPU_SYNC_IO", "") == "1"
        if archive_source and self.active:
            self.log_source_archive()

    # ---------------------------------------------------------- background writes

    def _io_submit(self, fn: Callable[[], None], what: str):
        """Run ``fn`` on the background writer (inline under
        ``EOE_TPU_SYNC_IO=1``); its exception becomes a warnings.txt line."""
        def guarded():
            try:
                fn()
            except Exception as e:
                self.warning(f"{what} failed: {e}", print_msg=False)
        if self._io_sync:
            guarded()
            return
        self._io_pending.append(_io_pool().submit(guarded))
        if len(self._io_pending) > 64:   # keep the list of futures bounded
            self._io_pending = [f for f in self._io_pending if not f.done()]

    def drain(self):
        """Block until every write queued so far is on disk."""
        pending, self._io_pending = self._io_pending, []
        for f in pending:
            f.result()

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

    def timeit(self, name: str = "") -> Timer:
        return Timer(self, name)

    def track(self, totals: Sequence[int], metrics: Optional[dict] = None,
              desc: str = "") -> Tracker:
        return Tracker(self, totals, metrics, desc)

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
        if not self.active:
            return
        self._scalars.setdefault(name, []).append((int(step), float(value)))
        if self.tb_writer is not None:
            self.tb_writer.add_scalar(name, value, step)

    def add_histogram(self, name: str, values, step: int):
        if self.active and self.tb_writer is not None:
            self.tb_writer.add_histogram(name, torch.as_tensor(np.asarray(values)), step)

    def hist(self, name: str, values, step: int = 0, bins: int = 30):
        """A histogram: tensorboard's where the writer is on, and a JSON
        record in scalars.json."""
        if not self.active:
            return
        vals = np.asarray(values, np.float64).reshape(-1)
        vals = vals[np.isfinite(vals)]
        if vals.size == 0:   # tensorboard's histogram raises on empty input
            return
        if self.tb_writer is not None:
            self.add_histogram(name, vals, step)
        counts, edges = np.histogram(vals, bins=bins)
        self._scalars.setdefault(f"hist/{name}", []).append(
            (int(step), {"counts": counts.tolist(), "edges": edges.tolist()}))

    def flush_scalars(self):
        if not self.active:
            return
        if self._scalars:
            with open(pt.join(self.dir, "scalars.json"), "w") as f:
                json.dump(self._scalars, f, cls=JsonEncoder)
        if self.tb_writer is not None:
            self.tb_writer.flush()

    def close(self):
        """Write the JSON records and close the tensorboard writer."""
        self.flush_scalars()
        if self.tb_writer is not None:
            self.tb_writer.close()
            self.tb_writer = None

    # ---------------------------------------------------------- images

    def logimg(self, name: str, images, nrow: int = 8, rowheaders: Optional[List[str]] = None):
        """Save an image grid as ``{name}.png`` with optional per-row header
        captions. ``images`` is (n, h, w, c), uint8 or float in [0, 1] (a
        numpy array or a tensor on any device). The images are copied to
        uint8 here and the grid is drawn and written in the background."""
        if not self.active:
            return
        try:
            import PIL  # noqa: F401
        except ImportError:
            return
        if isinstance(images, torch.Tensor):
            images = images.detach().cpu().numpy()
        imgs = np.asarray(images)
        imgs = imgs.copy() if imgs.dtype == np.uint8 else \
            (np.clip(imgs, 0, 1) * 255).astype(np.uint8)
        rowheaders = list(rowheaders) if rowheaders else rowheaders
        self._io_submit(lambda: self._render_img(name, imgs, nrow, rowheaders),
                        f"logimg({name})")

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
        matplotlib is installed (drawn in the background); returns the mean
        curve with the seed-wise std attached."""
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
            import matplotlib  # noqa: F401
        except ImportError:
            if not self._no_plots_said:
                self.print("matplotlib is not installed: ROC/PRC PDFs are not drawn")
                self._no_plots_said = True
            return
        labels = list(labels) if labels is not None else None
        self._io_submit(lambda: self._render_plot(curves, kept, labels, name, is_roc, mean),
                        f"plot_many({name})")

    def _render_plot(self, curves, kept, labels, name, is_roc, mean):
        # object-oriented matplotlib, no pyplot: safe off the main thread
        from matplotlib.figure import Figure
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
        'setup'} in the background. Its tensors must be CPU copies that
        nothing writes to afterwards; the path is complete once ``drain()``
        has returned."""
        if not self.active:
            return ""
        path = self.snapshot_path(name)

        def write():
            os.makedirs(pt.dirname(path), exist_ok=True)
            torch.save(payload, path)

        self._io_submit(write, f"snapshot({name})")
        return path
