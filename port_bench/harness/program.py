"""The system under test: the PyTorch + CUDA port, ``ctr_recommendation_tpu_torch``.
The only module of the harness that imports it. The benchmark takes from it
its entry points (``Trainer.train_step``, ``Predictor.score_table``), its
launch counters and the kernels' build; every input, weight and reference
is the benchmark's own."""

from __future__ import annotations

import torch

from ctr_recommendation_tpu_torch.config.loader import microlens_experiment
from ctr_recommendation_tpu_torch.data.item_store import ItemStore
from ctr_recommendation_tpu_torch.data.parquet import TableData
from ctr_recommendation_tpu_torch.features.feature_map import build_feature_map
from ctr_recommendation_tpu_torch.inference.predictor import Predictor
from ctr_recommendation_tpu_torch.ops.cuda import build as kernel_build
from ctr_recommendation_tpu_torch.ops.cuda import interaction, sasrec_encoder, scoring
from ctr_recommendation_tpu_torch.ops.cuda import table_grad as tg
from ctr_recommendation_tpu_torch.training.loop import Trainer

# the wrappers whose ``launches`` attributes count the hand-written kernels' launches
COUNTED = {
    "interaction_fwd": interaction.interaction_fwd,
    "interaction_bwd": interaction.interaction_bwd,
    "encode_fwd": sasrec_encoder.encode_fwd,
    "encode_bwd": sasrec_encoder.encode_bwd,
    "score_fwd": scoring.score_fwd,
    "table_grad": tg.table_grad,
}


def build_kernels() -> dict:
    """Compile the kernels that have no current library (the first run in
    a checkout), all at once; seconds per source built."""
    return kernel_build.build()


def experiment(config: dict, *, batch_size: int, total_steps: int | None = None,
               train_seed: int = 0, checkpoint_dir: str = ""):
    """The configuration's ExperimentConfig: ``microlens_experiment`` with
    the configuration's overrides and the traffic's batch, checked against
    every size the configuration file states."""
    kw = dict(config.get("overrides", {}))
    kw.update(batch_size=batch_size, seed=train_seed, tensorboard=False,
              checkpoint_dir=checkpoint_dir)
    exp = microlens_experiment(data_root="", model=config["model"], **kw)
    got = resolved_sizes(exp)
    moved = {k: (v, got[k]) for k, v in config["sizes"].items() if k in got and got[k] != v}
    if moved:
        raise SystemExit(f"the configuration as the port resolves it differs from "
                         f"{config['name']}'s file (stated, resolved): {moved}")
    return exp


def resolved_sizes(exp) -> dict:
    """Every size of ``config['sizes']`` as the port resolves it."""
    m, t, ds = exp.model, exp.train, exp.dataset
    fm = build_feature_map(ds)
    out = {k: getattr(m, k) for k in (
        "embedding_dim", "bilinear_type", "senet_reduction", "net_dropout", "batch_norm",
        "use_pallas", "tower_dtype", "attn_num_heads", "attn_num_layers", "attn_dropout")}
    out["hidden_units"] = list(m.hidden_units)
    out.update({k: getattr(t, k) for k in (
        "optimizer", "table_optimizer", "learning_rate", "weight_decay", "lr_schedule",
        "onecycle_peak_factor", "onecycle_pct_start", "onecycle_div_factor",
        "onecycle_final_div_factor", "grad_clip_norm", "compute_dtype", "param_dtype")})
    out["model"] = m.model
    out["fields"] = fm.num_fields
    out["item_vocab"] = ds.feature("item_id").vocab_size
    out["cate_vocab"] = ds.feature("likes_level").vocab_size
    out["max_len"] = ds.feature("item_seq").max_len
    out["mm_dim"] = ds.feature("item_emb_d128").dense_dim
    out["seq_pooling"] = "attention" if m.model == "sasrec_fibinet" else "mean"
    return out


def item_store(emb: torch.Tensor) -> ItemStore:
    """The benchmark's item matrix (on the device) as the port's item store."""
    return ItemStore(emb, None)


def trainer(exp, *, total_steps: int, store, params: dict, state: dict, device) -> Trainer:
    return Trainer(exp, total_steps=total_steps, checkpoint_dir=exp.train.checkpoint_dir,
                   item_store=store, params=params, model_state=state, device=device,
                   log_fn=lambda *a, **k: None)


def predictor(exp, *, store, params: dict, state: dict, device) -> Predictor:
    return Predictor(exp, params, state, item_store=store, device=device)


def table(cols: dict, n: int) -> TableData:
    return TableData(cols, n)


def counters() -> dict[str, int]:
    return {k: fn.launches for k, fn in COUNTED.items()}


def launches_per_call() -> dict:
    """Launches a call of each counted wrapper makes (one chunk of rows for
    the encoder), and the table gradient's per shape."""
    return {
        "interaction_fwd": interaction.fwd_launches(),
        "interaction_bwd": interaction.bwd_launches(),
        "encode_fwd": sasrec_encoder.fwd_launches,  # (layers)
        "encode_bwd": sasrec_encoder.bwd_launches,  # (layers)
        "score_fwd": scoring.score_launches(),
        "table_grad": tg.launches,  # (ids, rows, e)
    }


def first_gradients(tr: Trainer) -> dict[str, torch.Tensor]:
    """The first step's gradient as the optimizer took it (after the clip
    and L2), by leaf path, from Adam's first moment after one update:
    mu = (1 - b1) g. NaN where the optimizer did not make exactly one
    update (a step that left its state as it was reads as no gradient)."""
    st = tr.state.opt_state
    paths = list(getattr(tr, "_chain_paths", tr.param_paths))
    if st.get("count") != 1:
        return {p: torch.full_like(m, float("nan")) for p, m in zip(paths, st["mu"])}
    b1 = tr.tx.B1
    return {p: m / (1 - b1) for p, m in zip(paths, st["mu"])}


def params(tr: Trainer) -> dict[str, torch.Tensor]:
    return dict(tr.param_paths)
