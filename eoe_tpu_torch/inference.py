"""Serving API: batched anomaly scoring, the port of eoe_tpu/inference.py.

    scorer = AnomalyScorer(snapshot, model=CNN32(), test_specs=["normalize"])
    scorer = AnomalyScorer(snapshot, model=CLIP(VIT_B32), objective="clip",
                           center=prompt_center(...))
    scores = scorer.score(images)   # (n,) float32, larger = more anomalous

``snapshot`` is a port snapshot (the path of a ``torch.save`` of
``{"params": state_dict, "ds_statistics": ..., "setup": ...}``), such a dict
in memory, or a bare ``state_dict``. The JAX package's flax msgpack
snapshots carry across through ``models.clip.convert.from_flax`` (CLIP,
a ResNet tower's batch statistics included) and ``models.convert.from_flax``
(the conv models, batch statistics included); reference torch snapshots
through ``models.torch_import``.
The ``normalize`` placeholder takes the statistics stored in the snapshot.
The model runs on ``device``, ``cuda`` unless the caller asks for another
one.
"""

from typing import Optional, Sequence, Union

import numpy as np
import torch

from eoe_tpu_torch.device import resolve_device
from eoe_tpu_torch.ops.losses import OBJECTIVES, Objective
from eoe_tpu_torch.ops.preprocess import DatasetStats, compile_pipeline


class AnomalyScorer:
    def __init__(self, snapshot: Union[str, dict], model: torch.nn.Module,
                 objective: str = "hsc", test_specs: Optional[Sequence] = None,
                 batch_size: int = 128, center: Optional[torch.Tensor] = None,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        """
        @param snapshot: see the module docstring.
        @param model: the port module matching the snapshot's architecture,
            built with the compute dtype; it is moved to ``device``.
        @param objective: anomaly-score definition (OBJECTIVES key).
        @param test_specs: preprocessing spec list; defaults to the specs
            recorded in the snapshot's setup.
        @param center: objective reference tensor (the DSVDD feature centre,
            CLIP's text features) when the objective needs one.
        """
        self.device = resolve_device(device)
        payload = torch.load(snapshot, map_location="cpu", weights_only=True) \
            if isinstance(snapshot, str) else snapshot
        if "params" not in payload:
            payload = {"params": payload}
        self.objective: Objective = OBJECTIVES[objective]
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        if self.objective.needs_center and center is None:
            raise ValueError(
                f"objective '{objective}' needs a center (DSVDD feature center / "
                f"CLIP text-feature matrix); "
                f"pass it via the `center` argument")
        self.center = None if center is None else center.to(self.device)

        setup = payload.get("setup") or {}
        specs = list(test_specs) if test_specs is not None else \
            list(setup.get("test_specs") or [])
        stats = DatasetStats.from_json(payload.get("ds_statistics") or None)
        self._pipeline = compile_pipeline(specs, stats)
        model.load_state_dict(payload["params"])
        self.model = model.to(self.device).eval()

    @torch.inference_mode()
    def _score_batch(self, x: torch.Tensor) -> torch.Tensor:
        x = self._pipeline(x).to(self.compute_dtype)
        feats = self.model(x).float()
        kw = {"inputs": x} if self.objective.uses_inputs else {}
        return self.objective.score(feats, self.center, **kw).reshape(-1)

    def score(self, images: np.ndarray) -> np.ndarray:
        """Score (n, h, w, c) uint8 or float images; any n (the last chunk is
        padded to the batch size by repeating its last image)."""
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[None]
        n = len(images)
        B = self.batch_size
        outs = []
        for i in range(0, n, B):
            chunk = images[i: i + B]
            if len(chunk) < B:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], B - len(chunk), axis=0)])
            outs.append(self._score_batch(torch.from_numpy(chunk).to(self.device)))
        # one download instead of one per batch
        return torch.cat(outs).cpu().numpy()[:n]
