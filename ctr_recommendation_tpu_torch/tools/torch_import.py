"""Import a reference-format torch checkpoint into the port's MM-FiBiNET.

The reference trains with ``torch.save(model.state_dict())`` (DataParallel-
unwrapped) and its prediction script reloads it stripping any ``module.``
prefixes. This tool maps that state_dict layout onto the port's parameter
tree, the same tree the JAX package's ``tools/torch_import.py`` builds, so
an existing reference checkpoint is scored by the port directly.

State_dict -> params mapping (reference names):

    item_emb.weight (91718,E)    -> trunk.tables["item_id"][:91718]
    user_emb.weight (20000,E)    -> DROPPED (declared but unused in the
                                    reference forward; the user field is a
                                    zeros placeholder)
    cate_emb.weight (11,E)       -> trunk.tables["likes_level"][:11]
                                    (shared by views_level)
    mm_proj.0.{weight,bias}      -> trunk.dense[mm].proj (weight TRANSPOSED:
                                    torch Linear stores (out,in); the port
                                    stores (in,out) for x @ w)
    mm_proj.1.{weight,bias}      -> trunk.dense[mm].{ln_scale,ln_bias}
    senet.excitation.0.{w,b}     -> senet.fc1 (transposed)
    senet.excitation.2.{w,b}     -> senet.fc2 (transposed)
    bilinear.W (E,E)             -> bilinear.w  (NOT transposed: both sides
                                    compute v = x @ W)
    bilinear.W_list.{i}          -> bilinear.w_each[i]   ("each" variant)
    mlp.0/.4 Linear              -> mlp.layers[k].linear (transposed)
    mlp.1/.5 BatchNorm1d         -> mlp.layers[k].{bn_scale,bn_bias} +
                                    model_state mlp.layers[k].{bn_mean,bn_var}
    mlp.8 Linear (256,1)         -> mlp.out (transposed)

Embedding tables are vocab-padded to a multiple of 128 rows
(``models/trunk.py``); checkpoint rows land in the prefix and the padded
rows keep their init (no id addresses them). Every leaf comes back as a
float32 CPU tensor, as ``tools/jax_bridge.params_from_jax`` returns them.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ctr_recommendation_tpu_torch.config.schema import ExperimentConfig, FeatureType
from ctr_recommendation_tpu_torch.features.feature_map import FeatureMap, build_feature_map
from ctr_recommendation_tpu_torch.models.registry import get_model


def _t(v) -> torch.Tensor:
    """A state_dict value (tensor or array-like) as a float32 CPU tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(v, dtype=np.float32))


def strip_module_prefix(sd: dict) -> dict:
    """DataParallel checkpoints prefix every key with ``module.``."""
    return {re.sub(r"^module\.", "", k): v for k, v in sd.items()}


def _set_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """A copy of the (possibly vocab-padded) table with the checkpoint rows
    in its prefix."""
    n, e = rows.shape
    if table.shape[0] < n or table.shape[1] != e:
        raise ValueError(
            f"table shape {tuple(table.shape)} cannot hold checkpoint rows {tuple(rows.shape)}"
        )
    out = table.clone()
    out[:n] = rows
    return out


def import_state_dict(
    sd: dict,
    exp: ExperimentConfig,
    fm: FeatureMap | None = None,
    *,
    strict: bool = True,
) -> tuple[dict, dict]:
    """Map a reference MM_FiBiNET state_dict onto (params, model_state).

    Starts from the port's own ``init`` (so the structure and the padding
    are exactly what the Trainer and the Predictor expect) and overwrites
    every leaf the checkpoint carries. ``strict`` raises on unconsumed
    checkpoint keys (other than the declared-dead ``user_emb``)."""
    fm = fm or build_feature_map(exp.dataset)
    cfg = exp.model
    if cfg.model != "mm_fibinet":
        raise ValueError(
            f"reference checkpoints are MM_FiBiNET; experiment has {cfg.model!r}"
        )
    sd = strip_module_prefix(sd)
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    params, state = get_model(cfg.model).init(torch.Generator().manual_seed(0), fm, cfg)
    used: set[str] = {"user_emb.weight"}  # dead table, dropped by design

    def take(key: str, transpose: bool = False) -> torch.Tensor:
        if key not in sd:
            raise KeyError(f"checkpoint missing {key!r}")
        used.add(key)
        a = _t(sd[key])
        return a.t().contiguous() if transpose else a.clone()

    e = cfg.embedding_dim
    item_rows = _t(sd["item_emb.weight"])
    if item_rows.shape[1] != e:
        raise ValueError(
            f"checkpoint embedding_dim {item_rows.shape[1]} != config {e}"
        )

    tables = dict(params["trunk"]["tables"])
    # table names follow the owning feature (features/feature_map.py):
    # item_id owns the item/sequence table, likes_level the shared cate table
    tables["item_id"] = _set_rows(tables["item_id"], item_rows)
    used.add("item_emb.weight")
    tables["likes_level"] = _set_rows(tables["likes_level"], _t(sd["cate_emb.weight"]))
    used.add("cate_emb.weight")
    params["trunk"] = dict(params["trunk"])
    params["trunk"]["tables"] = tables

    # mm projection: Linear + LayerNorm
    dense = dict(params["trunk"]["dense"])
    for f in fm.features_of_type(FeatureType.DENSE_EMBEDDING):
        dense[f.name] = {
            "proj": {
                "w": take("mm_proj.0.weight", transpose=True),
                "b": take("mm_proj.0.bias"),
            },
            "ln_scale": take("mm_proj.1.weight"),
            "ln_bias": take("mm_proj.1.bias"),
        }
    params["trunk"]["dense"] = dense

    params["senet"] = {
        "fc1": {
            "w": take("senet.excitation.0.weight", transpose=True),
            "b": take("senet.excitation.0.bias"),
        },
        "fc2": {
            "w": take("senet.excitation.2.weight", transpose=True),
            "b": take("senet.excitation.2.bias"),
        },
    }
    if cfg.bilinear_type == "all":
        params["bilinear"] = {"w": take("bilinear.W")}
    else:
        n = fm.num_fields - 1
        params["bilinear"] = {
            "w_each": torch.stack([take(f"bilinear.W_list.{i}") for i in range(n)])
        }

    # MLP tower: Linear/BN1d/ReLU/Dropout x2 + head at indices 0,1,4,5,8
    mlp = {"layers": [], "out": None}
    mstate = {"layers": []}
    for tl, tb in ((0, 1), (4, 5)):
        mlp["layers"].append(
            {
                "linear": {
                    "w": take(f"mlp.{tl}.weight", transpose=True),
                    "b": take(f"mlp.{tl}.bias"),
                },
                "bn_scale": take(f"mlp.{tb}.weight"),
                "bn_bias": take(f"mlp.{tb}.bias"),
            }
        )
        mstate["layers"].append(
            {
                "bn_mean": take(f"mlp.{tb}.running_mean"),
                "bn_var": take(f"mlp.{tb}.running_var"),
            }
        )
    mlp["out"] = {
        "w": take("mlp.8.weight", transpose=True),
        "b": take("mlp.8.bias"),
    }
    params["mlp"] = mlp
    new_state = dict(state)
    new_state["mlp"] = mstate

    leftover = set(sd) - used
    if strict and leftover:
        raise ValueError(f"unconsumed checkpoint keys: {sorted(leftover)}")
    return params, new_state


def load_checkpoint(path: str, exp: ExperimentConfig, **kw) -> tuple[dict, dict]:
    """torch.load a reference ``FiBiNET_best.pth`` and import it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return import_state_dict(sd, exp, **kw)
