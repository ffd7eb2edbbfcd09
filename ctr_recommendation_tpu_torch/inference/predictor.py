"""Batched scoring path.

* BatchNorm folded into the tower linears (ops/mlp.fold_batch_norm), so the
  serving forward is plain matmul + ReLU;
* the item_info join is a device gather (ItemStore uploaded once);
* unknown items resolve to zero vectors (the reference's Prediction.py:39-42);
* with ``use_pallas`` and a 2-layer tower, the whole interaction + tower runs
  as the fused scoring kernel (ops/cuda/scoring.py); otherwise the model's
  eval forward runs, with the interaction kernel (ops/cuda/interaction.py)
  when ``use_pallas`` is set;
* for ``sasrec_fibinet`` the trunk runs the history through the encoder
  kernel (ops/cuda/sasrec_encoder.py) when ``use_pallas`` is set, on both
  branches;
* the zoo models (xdeepfm, din, ...) take the model's eval forward, plain
  PyTorch; only a tower named "mlp" is folded, as in the JAX Predictor
  (FinalMLP's two streams keep their BatchNorm, MaskNet has none).

While a profiler runs, ``score_table`` marks its stages as spans
(``utils/profiling.py``): ``score.upload``, ``score.batch`` a batch (the
trunk's ``trunk`` and the kernels' spans inside it), ``score.download``;
``Predictor.spans`` holds their times. ``uploaded_bytes`` counts the bytes
of the host columns ``score_table`` copied to the device, traced or not.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ctr_recommendation_tpu_torch.config.schema import ExperimentConfig, FeatureType
from ctr_recommendation_tpu_torch.data.device_store import (
    DeviceItemStore,
    dense_join_plan,
    device_join,
)
from ctr_recommendation_tpu_torch.features.feature_map import build_feature_map
from ctr_recommendation_tpu_torch.features.hashing import apply_hashing, hash_plan
from ctr_recommendation_tpu_torch.models import trunk as trunk_mod
from ctr_recommendation_tpu_torch.models.registry import get_model
from ctr_recommendation_tpu_torch.ops import mlp as mlp_ops
from ctr_recommendation_tpu_torch.ops.cuda.scoring import prepare_score_params, score_fwd
from ctr_recommendation_tpu_torch.utils.device import resolve_device
from ctr_recommendation_tpu_torch.utils.profiling import RECORDER, span
from ctr_recommendation_tpu_torch.utils.tree import tree_map


class Predictor:
    def __init__(
        self,
        experiment: ExperimentConfig,
        params: dict,
        model_state: dict,
        *,
        fold_bn: bool = True,
        item_store=None,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.exp = experiment
        self.uploaded_bytes = 0  # host column bytes score_table copied to the device
        self.fm = build_feature_map(experiment.dataset)
        self.module = get_model(experiment.model.model)

        def to_dev(t):
            return torch.as_tensor(t).to(self.device)

        self.params = tree_map(to_dev, params)
        self.model_state = tree_map(to_dev, model_state)
        self._fold_bn = fold_bn
        if fold_bn and "mlp" in self.params and "mlp" in self.model_state:
            self.params = dict(self.params)
            self.params["mlp"] = mlp_ops.fold_batch_norm(
                self.params["mlp"], self.model_state["mlp"]
            )
            self.model_state = dict(self.model_state)
            self.model_state["mlp"] = {"layers": [{} for _ in self.params["mlp"]["layers"]]}

        fm, cfg = self.fm, experiment.model
        # the trunk runs at train.compute_dtype; the tower at tower_dtype, as
        # the trainer's eval step does
        self.compute_dtype = getattr(torch, experiment.train.compute_dtype)
        self.tower_dtype = (
            torch.float32 if cfg.tower_dtype == "float32" else self.compute_dtype
        )

        # device-resident item join: the matrix is uploaded ONCE and shared
        # by every plan entry
        self._join_plan = dense_join_plan(fm)
        self._mm_tables: dict[str, torch.Tensor] = {}
        if item_store is not None and self._join_plan:
            emb = DeviceItemStore.from_host(item_store, self.device).emb
            for dense_name, _ in self._join_plan:
                self._mm_tables[dense_name] = emb
        self._hash_plan = hash_plan(fm)

        self.use_fused = (
            cfg.use_pallas
            and self._fold_bn
            and cfg.model in ("fibinet", "mm_fibinet", "sasrec_fibinet")
            and len(cfg.hidden_units) == 2
            and "mlp" in self.params
        )
        if self.use_fused:
            # the kernel's weight operands, cast to the tower dtype once
            self._score_weights = prepare_score_params(
                self.params["senet"], self.params["bilinear"], self.params["mlp"],
                bilinear_type=cfg.bilinear_type, compute_dtype=self.tower_dtype,
            )

    @property
    def spans(self):
        """The process's span recorder (``utils.profiling.RECORDER``)."""
        return RECORDER

    @torch.inference_mode()
    def _score(self, feats: dict[str, torch.Tensor]) -> torch.Tensor:
        """One batch of device columns -> click probabilities (B,) fp32."""
        cfg = self.exp.model
        # join by RAW ids first, then hash for the embedding lookup
        feats = apply_hashing(
            device_join(dict(feats), self._mm_tables, self._join_plan), self._hash_plan
        )
        if self.use_fused:
            x = trunk_mod.apply(
                self.params["trunk"], self.fm, cfg, feats,
                seq_pooling=self.module.SEQ_POOLING, compute_dtype=self.compute_dtype,
            )
            return score_fwd(
                x.to(self.tower_dtype).contiguous(), *self._score_weights,
                bilinear_type=cfg.bilinear_type,
            )
        logits, _ = self.module.apply(
            self.params, self.model_state, self.fm, cfg, feats,
            compute_dtype=self.compute_dtype,
        )
        return torch.sigmoid(logits)

    @torch.inference_mode()
    def score_batches(
        self, cols: dict[str, torch.Tensor], batch_size: int
    ) -> torch.Tensor:
        """Score device columns whose row count is a multiple of
        ``batch_size`` as fixed-size batches in order: the step shared by
        the bulk ``score_table`` and the pipelined chunk path, so both give
        identical probabilities."""
        n = next(iter(cols.values())).shape[0]
        out = torch.empty(n, dtype=torch.float32, device=self.device)
        for start in range(0, n, batch_size):
            with span("score.batch"):
                batch = {k: v[start : start + batch_size] for k, v in cols.items()}
                out[start : start + batch_size] = self._score(batch)
        return out

    def _upload(self, batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        return {
            k: torch.as_tensor(np.asarray(v)).to(self.device)
            for k, v in batch.items()
            if k not in (self.fm.label, "__weight__")
        }

    def __call__(self, batch: dict[str, np.ndarray]) -> torch.Tensor:
        return self._score(self._upload(batch))

    def predict_all(self, batches: Iterator[dict]) -> np.ndarray:
        out = []
        for batch in batches:
            probs = self(batch).cpu().numpy()
            w = np.asarray(batch.get("__weight__", np.ones(len(probs))))
            out.append(probs[w > 0])
        return np.concatenate(out) if out else np.zeros((0,), np.float32)

    def score_table(self, table, batch_size: int = 8192) -> np.ndarray:
        """Bulk-score a whole split (``table.columns``, ``table.num_rows``):
        the model-read columns are uploaded once, padded to whole batches,
        then scored batch by batch on the device."""
        n = table.num_rows
        if n == 0:
            return np.zeros((0,), np.float32)
        padded = -(-n // batch_size) * batch_size
        # PLACEHOLDER fields read no column; DENSE_EMBEDDING columns are
        # joined on the device from the ItemStore
        dead = {
            f.name
            for f in self.fm.features
            if f.type in (FeatureType.PLACEHOLDER, FeatureType.DENSE_EMBEDDING)
        }
        cols = {}
        with span("score.upload") as stage:
            for k, v in table.columns.items():
                if k == self.fm.label or k in dead or k == "__weight__":
                    continue
                if padded > n:
                    v = np.concatenate([v, np.zeros((padded - n, *v.shape[1:]), v.dtype)])
                cols[k] = torch.as_tensor(v).to(self.device)
                self.uploaded_bytes += v.nbytes
                stage.add_bytes(v.nbytes)
        out = self.score_batches(cols, batch_size)
        with span("score.download"):
            return out[:n].cpu().numpy()
