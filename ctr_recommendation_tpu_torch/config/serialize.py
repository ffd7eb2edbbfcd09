"""ExperimentConfig <-> JSON, so checkpoints are self-describing.

The reference hardcodes the model shape in code, so its Prediction.py can
rebuild the model blindly (Prediction.py:70-78). Here architecture comes from
config — so the trainer persists ``experiment.json`` next to its checkpoints
and the predict CLI reconstructs the exact model (vocab sizes, dims, model
name) from it instead of trusting defaults.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from ctr_recommendation_tpu_torch.config.schema import (
    DatasetConfig,
    ExperimentConfig,
    FeatureSpec,
    FeatureType,
    MeshConfig,
    ModelConfig,
    TrainConfig,
)


def to_dict(exp: ExperimentConfig) -> dict[str, Any]:
    d = dataclasses.asdict(exp)
    for f in d["dataset"]["features"]:
        f["type"] = f["type"].value if isinstance(f["type"], FeatureType) else f["type"]
    return d


def to_json(exp: ExperimentConfig) -> str:
    return json.dumps(to_dict(exp), indent=2)


def from_dict(d: dict[str, Any]) -> ExperimentConfig:
    ds = dict(d["dataset"])
    ds["features"] = tuple(
        FeatureSpec(**{**f, "type": FeatureType(f["type"])})
        for f in ds["features"]
    )
    # JSON has no tuples: every list-valued model field is a tuple field
    # (hidden_units, cin_layer_units, finalmlp_*_units, din_att_hidden_units,
    # and any future ones) — coerce generically so a new field can't silently
    # break the round-trip again.
    model = {
        k: tuple(v) if isinstance(v, list) else v for k, v in d["model"].items()
    }
    return ExperimentConfig(
        expid=d["expid"],
        dataset=DatasetConfig(**ds),
        model=ModelConfig(**model),
        train=TrainConfig(**d["train"]),
        mesh=MeshConfig(**d.get("mesh", {})),
    )


def from_json(s: str) -> ExperimentConfig:
    return from_dict(json.loads(s))


def save(exp: ExperimentConfig, path: str) -> None:
    with open(path, "w") as f:
        f.write(to_json(exp))


def load(path: str) -> ExperimentConfig:
    with open(path) as f:
        return from_json(f.read())
