"""Training driver: the JAX package's ``Trainer``, on one device or
data-parallel over the ranks of ``torch.distributed``.

Same semantics as the JAX package's training/loop.py:35-40, 231-489 and
989-1156: weighted BCE on logits, the dense optimizer chain (Adam + L2,
OneCycle stepped per batch, global-norm clip) over every parameter including
the embedding tables, per-epoch exact AUC + logloss with a best-metric
export, full-state resume points, ``metrics.csv`` and ``experiment.json``.
With ``table_optimizer != "dense"`` the tables take the sparse step instead
(``training/sparse.py``): per table a strategy from ``choose_strategy``; the
gathered tables' ids remapped once and differentiated through a detached
row buffer, the masked-dense tables through their own gradient; dense and
row gradients clipped jointly; the dense chain on the other leaves,
``TableOptimizer.update`` / ``update_dense`` on the tables. In both steps a
table read by two or more features (the item table: ``item_id`` and
``item_seq``) is looked up through ``multi_feature_lookup`` (of the table,
or of a gathered table's row buffer), one merged backward for all its
features: one ``table_grad`` (``ops/cuda/table_grad.py``) a table a step.

Two training loops share the step, the eval and the epoch's end (resume, the
best export, resume points, ``metrics.csv``):

* ``fit_on_device``: the split stays resident on the device; each epoch is
  a seeded permutation (or ``arange`` without shuffling) cut into
  ``batch_size`` batches.
* ``fit``: host-driven, over an iterator of numpy batches per epoch
  (``iter_batches``, ``stream_batches``; with the host item join of
  ``--strict-items`` they carry the dense item column). A prefetch thread
  uploads them, ``steps_per_dispatch`` batches at a time: stacked, each
  column at its narrowest safe wire dtype (``put_chunk``), staged in pinned
  memory and copied on the trainer's side stream; the step's stream waits
  on the copy's event, the chunk is widened on the device and its slices
  take one step each.

Each batch runs the device join, hashing, ``apply(train=True)``, BCE,
backward and the optimizer, eagerly. Losses accumulate on the device: the
host reads them at ``log_every`` and once per epoch. Dropout draws from a
generator reseeded from ``(seed + 1, step)`` at every step, as the JAX
package folds the step into its rng, so a resumed run draws the same masks.

Data-parallel (a ``mesh`` over a process group, ``parallel/``): one
process and one device a rank, each with a replica of the parameters
(checked equal to rank 0's at the start, ``sharding.put_global``). A step
computes what one process computes over the global batch of every rank's
rows (``parallel/data_parallel.py``): the loss is each rank's share of the
global mean, BatchNorm's statistics are global, dropout draws the global
batch's masks, the sparse tables dedup the global ids, and the gradients
(the fused interaction's fp32 weight gradients among them), row gradients
and the loss are summed across ranks in a few buckets before the clip and
the optimizer, which then run alike on every rank. Collectives are only
``all_reduce`` and ``broadcast``: NCCL for one rank a card, gloo on the CPU
(the tests) or for ranks that share one card. ``fit_on_device`` keeps the
whole split on every rank and takes ``batch_size`` as the global batch
(rank r steps through rows [r bs/W, (r + 1) bs/W) of each); ``fit`` takes
each rank's own batches, so the global batch is W x ``batch_size``, as in
the JAX package. Every rank evaluates the valid split and acts on rank 0's
metrics (a broadcast); rank 0 alone writes ``metrics.csv``,
``experiment.json``, resume points and the best export, and the ranks meet
at a barrier after each epoch's writes. Launch:
``torchrun --nproc_per_node N -m ctr_recommendation_tpu_torch.cli.train ...``.

Row-sharded tables (``model_parallel`` mp > 1, a (dp, mp) mesh): each rank
inits the whole tables from the seed and keeps its shard of each
(``sharding.shard_rows``) with the dense chain's moments that mirror it;
every table read goes through ``lookup`` (default
``parallel/embedding.py::make_sharded_lookup``, the merged-backward plan
off, as in JAX), in training and in eval. The ranks of one model group
hold the same rows: ``fit_on_device`` and ``fit`` keep them in lockstep,
``batch_size`` splitting over dp alone. The gradients are summed over the
data group, shards included; the global-norm clip sums the replicated
leaves' squares once and the shards' over the model group. World rank 0
alone writes; the checkpoint and the export hold whole tables (and
moments), gathered over the model group first, so ``Predictor`` serves
them on one device and ``--resume`` slices them again.

With a sparse ``table_optimizer`` at mp > 1 the gathered tables' rows come
from their owners (``embedding.owned_rows_gather``), each rank updating
its shard's rows alone; the masked-dense tables read through ``lookup``.

Each ``metrics.csv`` row is mirrored to TensorBoard (``<checkpoint_dir>/tb``,
``train.tensorboard``; silently off without the tensorboard package).
``profile_epoch`` writes a ``torch.profiler`` trace of one device-resident
epoch. While any profiler runs, ``train_step`` marks its stages as spans
(``utils/profiling.py``; ``Trainer.spans`` holds their times).
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import os
import time
from typing import Callable, Iterator

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ctr_recommendation_tpu_torch.config import serialize
from ctr_recommendation_tpu_torch.config.schema import ExperimentConfig, FeatureType
from ctr_recommendation_tpu_torch.data.device_store import (
    DeviceItemStore,
    dense_join_plan,
    device_join,
)
from ctr_recommendation_tpu_torch.data.prefetch import prefetch
from ctr_recommendation_tpu_torch.features.feature_map import build_feature_map
from ctr_recommendation_tpu_torch.features.hashing import apply_hashing, hash_plan
from ctr_recommendation_tpu_torch.models.registry import get_model
from ctr_recommendation_tpu_torch.models.trunk import gather
from ctr_recommendation_tpu_torch.parallel import data_parallel, sharding
from ctr_recommendation_tpu_torch.parallel.data_parallel import DataSlice
from ctr_recommendation_tpu_torch.parallel.embedding import make_sharded_lookup, owned_rows_gather
from ctr_recommendation_tpu_torch.parallel.mesh import Mesh, make_mesh
from ctr_recommendation_tpu_torch.tools.jax_bridge import flatten
from ctr_recommendation_tpu_torch.training import metrics as metrics_lib
from ctr_recommendation_tpu_torch.training import sparse as sparse_lib
from ctr_recommendation_tpu_torch.training.checkpoint import CheckpointManager
from ctr_recommendation_tpu_torch.training.optim import make_optimizer
from ctr_recommendation_tpu_torch.training.train_state import TrainState
from ctr_recommendation_tpu_torch.utils.device import resolve_device
from ctr_recommendation_tpu_torch.utils.profiling import RECORDER, span, trace
from ctr_recommendation_tpu_torch.utils.tb import ScalarWriter
from ctr_recommendation_tpu_torch.utils.tree import tree_map


def bce_with_logits(logits, labels, weight=None, data: DataSlice | None = None):
    """optax.sigmoid_binary_cross_entropy: the mean, or the weighted mean
    over max(sum(weight), 1). In a data-parallel step (``data``) this rank's
    share of the global one: its rows' sum over the global row count, or
    over the global max(sum(weight), 1), all-reduced before the division;
    the ranks' shares sum to the global loss."""
    labels = labels.float()
    losses = -(labels * F.logsigmoid(logits) + (1.0 - labels) * F.logsigmoid(-logits))
    if weight is None:
        return losses.mean() if data is None else losses.sum() / data.global_rows
    w = weight.float()
    total = w.sum()
    if data is not None:
        total = data_parallel.all_reduce_(total.reshape(1), data.group)[0]
    return (losses * w).sum() / total.clamp(min=1.0)


def _seed(base: int, index: int) -> int:
    """One 63-bit generator seed per (base, index) pair."""
    return ((base % (1 << 31)) << 31 | (index % (1 << 31))) % (1 << 63)


_ID_TYPES = (FeatureType.CATEGORICAL, FeatureType.SEQUENCE)
_TABLES = "trunk/tables/"  # path prefix of the embedding tables' leaves
_ROWS = "rows/"  # name prefix of a gathered table's row buffer


def _map_paths(tree, fn, prefix: str = ""):
    """A copy of a tree of dicts and lists with each leaf ``fn(path,
    leaf)``, paths as ``jax_bridge.flatten`` names them."""
    if isinstance(tree, dict):
        return {k: _map_paths(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_paths(v, fn, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


@dataclasses.dataclass
class StepAux:
    """What ``forward_loss`` hands ``gradients`` and ``apply_gradients``."""

    model_state: dict  # the forward's new BatchNorm state
    # the tensors the step differentiates, by name, in gradient order: the
    # parameter leaves by path (without the gathered tables) and each
    # gathered table's row buffer as "rows/<table>"
    targets: dict[str, torch.Tensor]
    uids: dict[str, torch.Tensor]  # gathered table -> its batch's unique ids
    loss: torch.Tensor | None = None  # the global loss, once ``gradients`` has run


@dataclasses.dataclass
class Upload:
    """Device tensors of a batch or a chunk whose copies may still run on
    the trainer's side stream until ``done`` (None: already usable)."""

    tensors: dict[str, torch.Tensor]
    done: torch.cuda.Event | None = None


class Trainer:
    # route tables read by two or more features through multi_feature_lookup
    _fuse_table_gather = True

    def __init__(
        self,
        experiment: ExperimentConfig,
        *,
        mesh: Mesh | None = None,
        total_steps: int | None = None,
        steps_per_epoch: int | None = None,
        checkpoint_dir: str | None = None,
        lookup: Callable | None = None,
        item_store=None,
        params: dict | None = None,
        model_state: dict | None = None,
        device: str | torch.device = "cuda",
        log_fn=print,
    ):
        """``params``/``model_state`` (tensors or numpy arrays in the JAX
        layout) replace the seeded init, e.g. to start from bridged JAX
        weights; they are copied, never aliased. ``mesh`` (default
        ``make_mesh(experiment.mesh)``: the process group's ranks, or one
        device without one) lays out the ranks; over a process group the
        trainer runs data-parallel on the mesh's data axis, with this
        rank's replica on ``device``, and with row-sharded tables on its
        model axis. ``lookup(tables, name, ids, feature=, batch_dim=)``
        replaces the trunk's gather (default: ``make_sharded_lookup`` of
        the mesh when its model axis has more than one rank, else none)."""
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(experiment.mesh, device=self.device)
        mc = experiment.mesh
        self._model_axis = mc.model_axis
        self._mp = self.mesh.shape[mc.model_axis]
        self._world = self.mesh.shape[mc.data_axis]
        self._rank = self.mesh.rank(mc.data_axis)
        # the data axis' process group: None for one process, and at mp > 1
        # for a data axis of one rank, which has nothing to reduce
        self._data = (self.mesh.group(mc.data_axis)
                      if self._world > 1 or self._mp == 1 else None)
        self.exp = experiment
        self.fm = build_feature_map(experiment.dataset)
        self.module = get_model(experiment.model.model)
        self.log = log_fn
        tc = experiment.train
        self.compute_dtype = getattr(torch, tc.compute_dtype)
        if total_steps is None:
            total_steps = (steps_per_epoch or 1000) * tc.epochs
        self.total_steps = total_steps
        self.tx, self.schedule = make_optimizer(
            tc, total_steps, sparse_tables=tc.table_optimizer != "dense")
        self.table_opt = sparse_lib.make_table_optimizer(tc, self.schedule)
        if self.table_opt is not None and lookup is not None:
            raise ValueError(
                "table_optimizer != 'dense' replaces the embedding lookup with its deduplicated "
                "row gather; an injected sharded lookup cannot be combined with it")
        if lookup is None and self._mp > 1:  # the masked-dense tables' too
            lookup = make_sharded_lookup(
                self.mesh, mc.model_axis, method=mc.lookup_method,
                capacity_factor=mc.lookup_capacity_factor, feature_map=self.fm)
        self.lookup = lookup
        if self.table_opt is not None:
            for f in self.fm.features_of_type(FeatureType.SEQUENCE):
                if f.pad_id != 0:
                    raise ValueError(
                        f"sparse table_optimizer requires pad_id 0 (feature {f.name!r} has "
                        f"pad_id {f.pad_id}): the batch id remap preserves the pad mask only "
                        "for id 0 (training/sparse.py remap_batch)")

        self.checkpoint_dir = checkpoint_dir or tc.checkpoint_dir
        self.ckpt = CheckpointManager(self.checkpoint_dir, max_to_keep=tc.keep_checkpoints)
        # metrics.csv's rows as TensorBoard scalars, from the rank that writes it
        self._tb = ScalarWriter(os.path.join(self.checkpoint_dir, "tb")
                                if tc.tensorboard and self._writes else None)
        # the checkpoint describes itself: predict rebuilds the model from
        # experiment.json. Written here only if absent; fit refreshes it.
        self._experiment_json = os.path.join(self.checkpoint_dir, "experiment.json")
        if not os.path.exists(self._experiment_json):
            self._save_experiment()

        # device-resident item join: the item matrix is uploaded once
        self._join_plan = dense_join_plan(self.fm)
        self._hash_plan = hash_plan(self.fm)
        self._mm_tables: dict[str, torch.Tensor] = {}
        if item_store is not None and self._join_plan:
            emb = DeviceItemStore.from_host(item_store, self.device).emb
            for dense_name, _ in self._join_plan:
                self._mm_tables[dense_name] = emb

        if params is None:
            params, model_state = self.module.init(
                torch.Generator().manual_seed(tc.seed), self.fm, experiment.model
            )
        params = tree_map(self._to_device, params)
        model_state = tree_map(self._to_device, model_state)
        # the leaves row-sharded over the model axis: at mp > 1 the 2-D tables;
        # each table's whole row count and the whole row its shard starts at
        self._sharded = set()
        self._table_rows = {t: v.shape[0] for t, v in params["trunk"]["tables"].items()}
        self._row0 = {t: 0 for t in self._table_rows}
        if self._mp > 1:
            tables = params["trunk"]["tables"]
            for t, full in tables.items():
                if full.dim() == 2:
                    tables[t] = sharding.shard_rows(full, self.mesh, mc.model_axis)
                    self._sharded.add(_TABLES + t)
                    self._row0[t] = self.mesh.model_rank * tables[t].shape[0]
        params = tree_map(lambda t: t.requires_grad_(), params)
        if self.mesh.device_mesh is not None:  # every rank must start from rank 0's values
            both = {"params": params, "model_state": model_state}
            sharding.put_global(both, sharding.tree_shardings(
                sharding.param_specs(both, self.mesh, mc.model_axis), self.mesh))
        self.param_paths = dict(flatten(params))
        self.param_leaves = list(self.param_paths.values())
        # the dense chain's leaves: all of them, or without the tables
        self._chain_paths = [p for p in self.param_paths
                             if self.table_opt is None or not p.startswith(_TABLES)]
        table_opt_state = {}
        if self.table_opt is not None:
            table_opt_state = self.table_opt.init(
                {t: v.detach() for t, v in params["trunk"]["tables"].items()})
        self.state = TrainState(
            0, params, model_state,
            self.tx.init([self.param_paths[p] for p in self._chain_paths]), table_opt_state)
        self._dropout_gen = torch.Generator(device=self.device)
        self.history: list[dict[str, float]] = []
        # fit's uploads: the wire dtypes, decided on the first chunk
        # (put_chunk), and the side stream the copies run on
        self._wire_plan: dict | None = None
        self._h2d_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def _to_device(self, t) -> torch.Tensor:
        return torch.as_tensor(t).detach().to(self.device, torch.float32, copy=True)

    # ------------------------------------------------------------------ steps
    def _device_join(self, feats: dict) -> dict:
        # join by RAW ids first, then hash for the embedding lookup
        return apply_hashing(device_join(feats, self._mm_tables, self._join_plan), self._hash_plan)

    def _multi_feature_plan(self, feats: dict) -> dict[str, list]:
        """Tables read by two or more features (the item table: item_id and
        item_seq), with each feature's ids in the layout the trunk asks
        for: mean-pooled sequences transposed (S, B), attention-pooled ones
        (B, S). A table with a square (S == B) sequence keeps the
        per-feature gathers: the two layouts are indistinguishable by
        shape."""
        if not self._fuse_table_gather or self.lookup is not None:
            return {}  # an injected lookup owns the gathers
        fm = self.fm
        id_feats = [f for f in fm.features if f.type in _ID_TYPES and f.name in feats]
        tables = {fm.table_of[f.name] for f in id_feats}
        transposed = self.module.SEQ_POOLING == "mean"
        multi: dict[str, list] = {}
        for t in sorted(tables):
            fs = [f for f in id_feats if fm.table_of[f.name] == t]
            if len(fs) < 2 or any(f.type == FeatureType.SEQUENCE
                                  and feats[f.name].shape[0] == feats[f.name].shape[1]
                                  for f in fs):
                continue
            multi[t] = [
                (f.name, feats[f.name].t() if f.type == FeatureType.SEQUENCE and transposed
                 else feats[f.name])
                for f in fs
            ]
        return multi

    @staticmethod
    def _merged_lookup(tables: dict, rows: dict, multi: dict, base=None):
        """The trunk's lookup for one step: planned features read their share
        of ``multi_feature_lookup`` (one ``table_grad`` a table in the
        backward), of the table or, for a gathered table, of its row buffer;
        other features of a gathered table ``gather`` its row buffer; the
        rest ``base`` (default ``gather``)."""
        cache: dict[str, tuple[tuple, torch.Tensor]] = {}
        for t, segs in multi.items():
            outs = sparse_lib.multi_feature_lookup(rows[t] if t in rows else tables[t],
                                                   *[ids for _, ids in segs])
            for (name, ids), o in zip(segs, outs):
                cache[name] = (tuple(ids.shape), o)

        def lookup(tbls, name, ids, feature=None, batch_dim=0):
            if feature in cache:
                canon, o = cache[feature]
                if tuple(ids.shape) == canon:
                    return o
                if ids.dim() == 2 and tuple(ids.shape) == canon[::-1]:
                    return o.transpose(0, 1)
            if name in rows:
                return gather(rows[name], ids)
            if base is not None:
                return base(tbls, name, ids, feature=feature, batch_dim=batch_dim)
            return gather(tbls[name], ids)

        return lookup

    def _plan_step(self, feats: dict, data: DataSlice | None = None):
        """(feats, lookup, targets, uids) of one step on joined feats; in a
        data-parallel step (``data``) the strategies follow the global
        batch's id counts and the gathered tables' uids are the global
        batch's."""
        tables = self.state.params["trunk"]["tables"]
        if self.table_opt is None:
            multi = self._multi_feature_plan(feats)
            lookup = self._merged_lookup(tables, {}, multi) if multi else self.lookup
            return feats, lookup, self.param_paths, {}
        fm = self.fm
        counts: dict[str, int] = {}  # ids per table, the forced pad id included
        for f in fm.features:
            if f.type in _ID_TYPES and f.name in feats:
                t = fm.table_of[f.name]
                counts[t] = counts.get(t, 1) + feats[f.name].numel() * self._world
        gathered = sorted(t for t, c in counts.items()
                          if sparse_lib.choose_strategy(self._table_rows[t], c) == "gathered")
        masked = [t for t in counts if t not in gathered]
        feats, uids = sparse_lib.remap_batch(fm, feats, tables, only=gathered, data=data,
                                             rows=self._table_rows)
        # at mp > 1 the uids' rows come from their owners (the psum exchange)
        rows = {t: (sparse_lib.gather_rows(tables[t].detach(), u) if self._mp == 1 else
                    owned_rows_gather(tables[t], u, self.mesh, self._model_axis)).requires_grad_()
                for t, u in uids.items()}
        lookup = self._merged_lookup(tables, rows, self._multi_feature_plan(feats),
                                     base=self.lookup)
        targets = {p: self.param_paths[p] for p in self._chain_paths}
        targets.update({_TABLES + t: tables[t] for t in masked})
        targets.update({_ROWS + t: r for t, r in rows.items()})
        return feats, lookup, targets, uids

    def _slice(self, rows: int) -> DataSlice | None:
        """This rank's share of a step whose batch holds ``rows`` rows a rank
        (None for one process)."""
        return None if self._data is None else DataSlice(self._data, self._world, self._rank,
                                                         rows)

    def forward_loss(self, batch: dict[str, torch.Tensor]) -> tuple[torch.Tensor, StepAux]:
        """(loss, StepAux) of one train-mode forward on a batch of device
        columns, with the dropout masks of the current step. Data-parallel,
        the batch is this rank's rows and the loss its share of the global
        loss."""
        fm = self.fm
        weight = batch.get("__weight__")
        feats = {k: v for k, v in batch.items() if k not in (fm.label, "__weight__")}
        data = self._slice(len(batch[fm.label]))
        with data_parallel.step_slice(data):
            with span("train.join"):
                feats, lookup, targets, uids = self._plan_step(self._device_join(feats), data)
            self._dropout_gen.manual_seed(_seed(self.exp.train.seed + 1, self.state.step))
            logits, new_mstate = self.module.apply(
                self.state.params, self.state.model_state, fm, self.exp.model, feats,
                train=True, generator=self._dropout_gen, compute_dtype=self.compute_dtype,
                weight=weight, lookup=lookup,
            )
            with span("train.loss"):
                loss = bce_with_logits(logits, batch[fm.label], weight, data)
        return loss, StepAux(new_mstate, targets, uids)

    def gradients(self, loss: torch.Tensor, aux: StepAux) -> list[torch.Tensor]:
        """d loss / d each of ``aux.targets``, in order (with dense tables:
        every parameter, in ``param_leaves`` order). Data-parallel, the
        ranks' gradients and loss shares are summed across the ranks
        (``aux.loss``: the global loss)."""
        with span("train.backward"):
            grads = list(torch.autograd.grad(
                loss, list(aux.targets.values()), allow_unused=True, materialize_grads=True
            ))
        aux.loss = loss.detach()
        if self._data is not None:
            total = aux.loss.reshape(1).clone()
            data_parallel.all_reduce_buckets_([*grads, total], self._data)
            aux.loss = total[0]
        return grads

    def apply_gradients(self, grads: list[torch.Tensor], aux: StepAux) -> None:
        """The optimizer update (params change in place) and the step."""
        if self.table_opt is None:
            self.tx.update(grads, self.state.opt_state, self.param_leaves,
                           global_norm=lambda g: self._global_norm(g, self._chain_paths))
        else:
            self._apply_sparse(dict(zip(aux.targets, grads)), aux.uids)
        self.state.model_state = aux.model_state
        self.state.step += 1

    @torch.no_grad()
    def _apply_sparse(self, grads: dict[str, torch.Tensor], uids: dict) -> None:
        """Joint clip of dense and row gradients (the reference clips over
        every parameter), then the dense chain on the non-table leaves and
        the table optimizer on the tables."""
        clip = self.exp.train.grad_clip_norm
        if clip and clip > 0:
            g = list(grads.values())
            norm = self._global_norm(g, list(grads))
            torch._foreach_mul_(g, (clip / norm.clamp(min=1e-16)).clamp(max=1.0))
        self.tx.update([grads[p] for p in self._chain_paths], self.state.opt_state,
                       [self.param_paths[p] for p in self._chain_paths])
        tables, tstate = self.state.params["trunk"]["tables"], self.state.table_opt_state
        step = self.state.step
        masked = [p[len(_TABLES):] for p in grads if p.startswith(_TABLES)]
        if masked:
            self.table_opt.update_dense({t: tables[t] for t in masked}, tstate,
                                        {t: grads[_TABLES + t] for t in masked}, step)
        if uids:
            self.table_opt.update({t: tables[t] for t in uids}, tstate, uids,
                                  {t: grads[_ROWS + t] for t in uids}, step,
                                  row0=self._row0 if self._mp > 1 else None)

    def _global_norm(self, grads: list[torch.Tensor], paths: list[str]) -> torch.Tensor:
        """The global L2 norm of ``grads`` (named by ``paths``) over the
        whole model: at mp > 1 the replicated leaves' squares counted once
        and the table shards' summed over the model group, so that every
        rank clips alike."""
        norms = torch.stack(torch._foreach_norm(grads))
        if self._mp == 1:
            return torch.linalg.vector_norm(norms)
        sq = norms.square()
        mask = torch.tensor([p in self._sharded for p in paths], device=sq.device)
        shards = torch.where(mask, sq, 0.0).sum().reshape(1)
        data_parallel.all_reduce_(shards, self.mesh.group(self._model_axis))
        return (torch.where(mask, 0.0, sq).sum() + shards[0]).sqrt()

    def train_step(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """One optimizer step; returns the (global) batch loss as a device
        scalar."""
        with span("train.step"):
            with torch.enable_grad():
                loss, aux = self.forward_loss(batch)
                grads = self.gradients(loss, aux)
            with span("train.optimizer"):
                self.apply_gradients(grads, aux)
        return aux.loss

    @property
    def spans(self):
        """The process's span recorder (``utils.profiling.RECORDER``): while
        a ``torch.profiler`` runs, ``train_step`` records ``train.step`` and
        its stages in it (``train.join``, the model's ``trunk``,
        ``interaction`` and ``tower``, ``train.loss``, ``train.backward``
        with the backward stages ``tower.bwd``, ``interaction.bwd`` and
        ``trunk.bwd`` where the model marks them, ``train.optimizer``)."""
        return RECORDER

    # ------------------------------------------------------------------ state
    def _shard(self, path: str, whole) -> torch.Tensor:
        """A checkpoint's leaf at ``path`` as this rank holds it: its rows
        of a row-sharded table, else the whole."""
        t = torch.as_tensor(whole)
        return sharding.shard_rows(t, self.mesh, self._model_axis) if path in self._sharded else t

    def _moments(self, opt_state: dict, fn) -> dict:
        """The dense chain's state with ``fn(path, leaf)`` on each moment
        (the lists that mirror ``_chain_paths``)."""
        return {k: [fn(p, t) for p, t in zip(self._chain_paths, v)] if isinstance(v, list) else v
                for k, v in opt_state.items()}

    def _restore(self, payload: dict) -> None:
        """Restore a resume point (whole tables: a rank keeps its rows)."""
        flat = flatten(payload["params"])
        with torch.no_grad():
            for path, dst in self.param_paths.items():
                dst.copy_(self._shard(path, flat[path]))
        self.state.model_state = tree_map(self._to_device, payload["model_state"])
        self.state.table_opt_state = _map_paths(
            payload.get("table_opt_state", {}),
            lambda p, t: self._to_device(self._shard(_TABLES + p.split("/")[0], t)))
        self.state.opt_state = self._moments(
            payload["opt_state"], lambda p, t: self._to_device(self._shard(p, t)))
        self.state.step = int(payload["step"])

    def load_best(self) -> None:
        """Swap in the best export's params and model state."""
        params_np, mstate_np = self.ckpt.restore_best()
        flat = flatten(params_np)
        with torch.no_grad():
            for path, t in self.param_paths.items():
                t.copy_(self._shard(path, flat[path]))
        self.state.model_state = tree_map(self._to_device, mstate_np)

    def _whole_state(self) -> TrainState:
        """The train state as one process holds it: at mp > 1 each table and
        its moments gathered whole over the model group (every rank of the
        group must call this), else the state itself."""
        if self._mp == 1:
            return self.state

        def whole(path, t):
            t = t.detach()
            return sharding.unshard_rows(t, self.mesh, self._model_axis) \
                if path in self._sharded else t

        st = self.state
        return TrainState(st.step, _map_paths(st.params, whole), st.model_state,
                          self._moments(st.opt_state, whole),
                          _map_paths(st.table_opt_state,
                                     lambda p, t: whole(_TABLES + p.split("/")[0], t)))

    def _state_to_write(self) -> TrainState | None:
        """The whole state on the rank that writes, None on the others. At
        mp > 1 the model group of data rank 0 gathers the tables together."""
        if self._mp > 1 and self.mesh.data_rank != 0:
            return None
        st = self._whole_state()
        return st if self._writes else None

    @property
    def _writes(self) -> bool:
        """Whether this process writes the checkpoint directory: world rank
        0 alone (at mp > 1 the model ranks of data rank 0 do not)."""
        return self.mesh.writes

    def _save_experiment(self) -> None:
        if not self._writes:
            return
        try:
            serialize.save(self.exp, self._experiment_json)
        except OSError:
            pass

    def _seed_history(self, start_epoch: int) -> None:
        """On resume, reload the persisted rows of epochs <= start_epoch so
        the rewritten metrics.csv keeps them."""
        if self.history:
            return
        try:
            with open(os.path.join(self.checkpoint_dir, "metrics.csv"), newline="") as f:
                rows = list(csv.DictReader(f))
        except OSError:
            return
        for r in rows:
            parsed = {k: float(v) for k, v in r.items() if v not in (None, "")}
            if parsed.get("epoch", 0) <= start_epoch:
                self.history.append(parsed)

    def _seed_best(self, best: float) -> float:
        """On resume, continue the best-tracker from the persisted export's
        metric so a worse epoch cannot overwrite the best export."""
        persisted = self.ckpt.best_metric()
        if persisted is None:
            return best
        tc = self.exp.train
        self.log(f"[resume] best {tc.monitor} so far: {persisted:.4f}")
        return max(best, persisted) if tc.monitor_mode == "max" else min(best, persisted)

    def _write_history_csv(self) -> None:
        if self.history:
            last = self.history[-1]
            self._tb.scalars(int(last.get("epoch", len(self.history))), last)
        keys: list[str] = []
        for h in self.history:
            keys += [k for k in h if k not in keys]
        with open(os.path.join(self.checkpoint_dir, "metrics.csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(self.history)

    # ------------------------------------------------------------------ train
    def _upload(self, table) -> dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in table.columns.items()}

    def _permutation(self, epoch: int, n: int) -> torch.Tensor:
        if not self.exp.train.shuffle:
            return torch.arange(n, device=self.device)
        gen = torch.Generator().manual_seed(_seed(self.exp.train.seed + 2, epoch))
        return torch.randperm(n, generator=gen).to(self.device)

    def _resume(self, resume: bool) -> tuple[float, int]:
        """(best metric so far, first epoch to run): with ``resume``, the
        latest resume point restored, the best-tracker and the history of
        earlier epochs reloaded."""
        tc = self.exp.train
        best = -np.inf if tc.monitor_mode == "max" else np.inf
        start_epoch = 0
        if resume:
            latest = self.ckpt.latest_step()
            if latest is not None:
                self._restore(self.ckpt.restore(latest))
                start_epoch = latest
                self.log(f"[resume] epoch {start_epoch} step {self.state.step}")
            best = self._seed_best(best)
            self._seed_history(start_epoch)
        return best, start_epoch

    def _close_epoch(self, epoch: int, train_loss: float, rows: int, dt: float,
                     evaluate: Callable[[], dict] | None, best: float) -> float:
        """The end of an epoch, shared by both training loops: the non-finite-loss
        check, the eval, the best export on improvement, the resume point
        every ``checkpoint_every`` epochs and at the last, the log line and
        the history row (``metrics.csv``). Returns the best metric."""
        tc = self.exp.train
        if not np.isfinite(train_loss):
            raise FloatingPointError(
                f"non-finite train loss at epoch {epoch + 1}: {train_loss} "
                "(torch.autograd.set_detect_anomaly localizes it)"
            )
        entry: dict[str, float] = {
            "epoch": epoch + 1,
            "train_loss": train_loss,
            "examples_per_sec": rows / dt if dt > 0 else 0.0,
            "seconds": dt,
        }
        if evaluate is not None:
            t_eval = time.perf_counter()
            entry.update(self._agree(evaluate()))
            entry["eval_seconds"] = time.perf_counter() - t_eval
            metric = entry[tc.monitor]
            if metric > best if tc.monitor_mode == "max" else metric < best:
                best = metric
                st = self._state_to_write()
                if st is not None:
                    self.ckpt.save_best(st.params, st.model_state, metric, st.step)
                self.log(f"[epoch {epoch + 1}] new best {tc.monitor}={metric:.4f} — exported")
        t_save = time.perf_counter()
        if (epoch + 1) % tc.checkpoint_every == 0 or epoch + 1 == tc.epochs:
            st = self._state_to_write()
            if st is not None:
                self.ckpt.save(epoch + 1, st)
            entry["checkpoint_seconds"] = time.perf_counter() - t_save
        else:
            entry["checkpoint_seconds"] = 0.0  # every row keeps one schema
        self.log(
            f"[epoch {epoch + 1}] loss {train_loss:.4f} "
            + " ".join(f"{k} {v:.4f}" for k, v in entry.items() if k in ("auc", "logloss"))
            + f" ({rows}/{dt:.2f}s = {entry['examples_per_sec']:.0f} ex/s)"
        )
        self.history.append(entry)
        if self._writes:
            self._write_history_csv()
        if self.mesh.device_mesh is not None:  # no rank runs ahead of rank 0's writes
            dist.barrier()
        return best

    def _agree(self, metrics: dict[str, float]) -> dict[str, float]:
        """World rank 0's eval metrics on every rank (a broadcast), so that
        every rank takes the same best-export decision."""
        if self.mesh.device_mesh is None:
            return metrics
        keys = sorted(metrics)
        t = torch.tensor([metrics[k] for k in keys], dtype=torch.float64, device=self.device)
        dist.broadcast(t, 0)
        return dict(zip(keys, t.tolist()))

    def _rank_rows(self, bs: int) -> slice:
        """This rank's rows [r bs/W, (r + 1) bs/W) of each global batch of
        ``bs`` rows."""
        if bs % self._world:
            raise ValueError(f"batch_size {bs} (the global batch) does not divide over "
                             f"{self._world} data-parallel ranks")
        local = bs // self._world
        return slice(self._rank * local, (self._rank + 1) * local)

    def _device_epoch(self, data: dict[str, torch.Tensor], perm: torch.Tensor, steps: int,
                      rows: slice) -> torch.Tensor:
        """``steps`` train steps on the device-resident columns ``data``,
        step i on ``rows`` of the global batch ``perm[i bs : (i + 1) bs]``;
        the losses (steps,) stay on the device."""
        bs = self.exp.train.batch_size
        losses = torch.empty(steps, device=self.device)
        for i in range(steps):
            idx = perm[i * bs + rows.start : i * bs + rows.stop]
            losses[i] = self.train_step({k: v[idx] for k, v in data.items()})
        return losses

    def profile_epoch(self, train, log_dir: str) -> None:
        """A ``torch.profiler`` trace of one device-resident epoch
        (``utils.profiling.trace``: ``log_dir/rank<R>.pt.trace.json``).
        The split is uploaded and one untraced epoch runs first: it builds
        the kernels and warms the caching allocator, so that the trace holds
        the steady state. Then the same ``train.num_rows // batch_size``
        steps run again, over the same fixed permutation (torch seed 0),
        inside the trace. Both epochs update the state; no eval, no
        ``metrics.csv``, no checkpoint. Data-parallel, each rank takes its
        rows of each global batch, as in ``fit_on_device``, and writes its
        own trace."""
        bs = self.exp.train.batch_size
        steps = max(train.num_rows // bs, 1)
        rows = self._rank_rows(bs)
        data = self._upload(train)
        perm = torch.randperm(train.num_rows, generator=torch.Generator().manual_seed(0))
        perm = perm.to(self.device)
        float(self._device_epoch(data, perm, steps, rows).sum())  # waits for the epoch
        with trace(log_dir):
            self._device_epoch(data, perm, steps, rows)
        self.log(f"[profile] trace written to {log_dir}")

    def fit_on_device(self, train, valid=None, *, resume: bool = False) -> list[dict[str, float]]:
        """Train with the whole split resident on the device: each epoch is
        one shuffled pass of ``train.num_rows // batch_size`` full batches
        (drop_last), then an eval of ``valid``. ``train``/``valid`` are
        TableData; dense item features come from the device-side join.
        Data-parallel, every rank holds the whole split and the same
        permutation, and ``batch_size`` is the global batch: rank r takes
        rows [r bs/W, (r + 1) bs/W) of each."""
        tc = self.exp.train
        self._save_experiment()  # training owns the checkpoint's provenance
        bs, n = tc.batch_size, train.num_rows
        steps = n // bs
        if steps == 0:
            raise ValueError(f"batch_size {bs} > split rows {n}")
        rows = self._rank_rows(bs)
        data = self._upload(train)
        evaluate = None
        if valid is not None:
            prepared = self._prepare_eval_split(valid, tc.eval_batch_size)
            evaluate = lambda: self._evaluate_prepared(prepared)  # noqa: E731
        best, start_epoch = self._resume(resume)
        run_start = len(self.history)
        for epoch in range(start_epoch, tc.epochs):
            t0 = time.perf_counter()
            losses = self._device_epoch(data, self._permutation(epoch, n), steps, rows)
            train_loss = float(losses.mean())  # the epoch's one host read
            best = self._close_epoch(epoch, train_loss, steps * bs,
                                     time.perf_counter() - t0, evaluate, best)
        self.log(f"Done. Best {tc.monitor}: {best:.4f}")
        return self.history[run_start:]

    # ------------------------------------------------- host-driven training
    def _wire_dtype(self, key: str, first: np.ndarray):
        """Narrowest safe wire encoding of a streamed column, decided once
        on the first chunk: a numpy dtype, ``"split24"`` (a uint16 low half
        and a uint8 high byte, 3 B an element) or None (as it is). Binary
        labels and weights ride as uint8, ids of a vocab up to 2^8 / 2^16 as
        uint8 / uint16, up to 2^24 as split24 (item_id and item_seq at
        MicroLens scale, vocab 91718); hashed or negative ids and soft
        labels are never narrowed. The step widens them on the device."""
        if key in (self.fm.label, "__weight__"):
            # only exactly-representable {0..255} integral values
            if first.dtype == np.float32 and np.all(first == first.astype(np.uint8)):
                return np.dtype(np.uint8)
            return None
        for f in self.fm.features:
            if f.name != key or f.type not in _ID_TYPES:
                continue
            t = self.fm.table(self.fm.table_of[f.name])
            if t.hashed or first.min() < 0:
                return None  # raw ids until the on-device hashing
            if t.vocab_size <= 1 << 8:
                return np.dtype(np.uint8)
            if t.vocab_size <= 1 << 16:
                return np.dtype(np.uint16)
            if t.vocab_size <= 1 << 24:
                return "split24"
        return None

    def put_batch(self, batch: dict[str, np.ndarray]) -> Upload:
        """Numpy columns to the device, each at its own dtype. On the card:
        staged in pinned memory and copied ``non_blocking`` on the trainer's
        side stream, with an event that ``_ready`` makes the step's stream
        wait on."""
        if self._h2d_stream is None:
            return Upload({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()})
        with torch.cuda.stream(self._h2d_stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(self.device, non_blocking=True) for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(self._h2d_stream)
        return Upload(out, done)

    def _ready(self, up: Upload) -> dict[str, torch.Tensor]:
        """An upload's tensors, usable on the current stream: it waits for
        the copies, and owns the tensors for the caching allocator (which
        would otherwise reuse their memory once the side stream is done)."""
        if up.done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(up.done)
            for t in up.tensors.values():
                t.record_stream(stream)
        return up.tensors

    def put_chunk(self, buf: list[dict[str, np.ndarray]]) -> Upload:
        """K same-shape numpy batches stacked to (K, B, ...) and uploaded,
        each column at its wire dtype (``_wire_dtype``): uint8 as such, a
        uint16 column as the int16 of its bits under ``<name>__u16``, a
        split24 column as ``<name>__lo16`` (int16 bits) and ``<name>__hi8``
        (uint8); ``_widen`` undoes each on the device. PLACEHOLDER columns
        (zero fields that read no column) stay off the wire. A column that
        outgrows its plan (an id of 2^24 or more, soft labels) widens to its
        own dtype for the rest of the stream."""
        dead = {f.name for f in self.fm.features if f.type == FeatureType.PLACEHOLDER}
        stacked = {k: np.stack([b[k] for b in buf]) for k in buf[0] if k not in dead}
        if self._wire_plan is None:
            self._wire_plan = {k: dt for k, v in stacked.items()
                               if (dt := self._wire_dtype(k, v)) is not None}
        for k, dt in list(self._wire_plan.items()):
            v = stacked[k]
            if dt == "split24":
                if v.min() < 0 or (v >> 24).any():
                    self._wire_plan.pop(k)
                    self.log(f"[stream] column {k!r} no longer fits the 24-bit split wire "
                             "encoding; widening to int32 for the remaining chunks")
                    continue
                del stacked[k]
                stacked[k + "__lo16"] = (v & 0xFFFF).astype(np.uint16).view(np.int16)
                stacked[k + "__hi8"] = (v >> 16).astype(np.uint8)
                continue
            w = v.astype(dt)
            if v.dtype != dt and not np.array_equal(w, v):
                self._wire_plan.pop(k)
                self.log(f"[stream] column {k!r} no longer fits wire dtype {dt}; widening "
                         f"to {v.dtype} for the remaining chunks")
                continue
            if dt == np.uint16:  # torch's uint16 is a limited dtype: ship its bits
                del stacked[k]
                stacked[k + "__u16"] = w.view(np.int16)
            else:
                stacked[k] = w
        return self.put_batch(stacked)

    def _widen(self, cols: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Undo ``put_chunk``'s wire narrowing on the device: uint8 labels
        and weights to float32, uint8 ids to int32, the uint16 bits and the
        split24 halves recombined into int32."""
        def u16(t):
            return t.to(torch.int32) & 0xFFFF

        wide = {}
        for k, v in cols.items():
            if k.endswith("__hi8"):
                continue  # taken with its __lo16 half
            if k.endswith("__lo16"):
                base = k[: -len("__lo16")]
                wide[base] = u16(v) | (cols[base + "__hi8"].to(torch.int32) << 16)
            elif k.endswith("__u16"):
                wide[k[: -len("__u16")]] = u16(v)
            elif v.dtype == torch.uint8:
                wide[k] = v.to(torch.float32 if k in (self.fm.label, "__weight__")
                               else torch.int32)
            else:
                wide[k] = v
        return wide

    @staticmethod
    def _chunked(batches: Iterator[dict], k: int) -> Iterator[list[dict]]:
        """Group consecutive same-structure batches into lists of up to k; a
        batch whose keys, shapes or dtypes differ from the open chunk's
        flushes it (stacking needs uniformity)."""
        buf: list[dict] = []

        def sig(b):
            return tuple(sorted((key, v.shape, v.dtype) for key, v in b.items()))

        for b in batches:
            if buf and (len(buf) == k or sig(b) != sig(buf[0])):
                yield buf
                buf = []
            buf.append(b)
        if buf:
            yield buf

    def _device_batches(self, batches: Iterator[dict], k: int) -> Iterator[dict]:
        """One epoch's device batches, one a step. A prefetch thread uploads
        them (``put_batch`` at k = 1); at k > 1 a second one assembles them
        and the first uploads each chunk of k (``put_chunk``), which is made
        ready, widened and cut into its k batches here."""
        if k == 1:
            feed = prefetch(iter(batches), transform=self.put_batch)
        else:
            feed = prefetch(self._chunked(prefetch(iter(batches), depth=2 * k), k),
                            transform=self.put_chunk)
        with contextlib.closing(feed):
            for up in feed:
                cols = self._ready(up)
                if k == 1:
                    yield cols
                    continue
                wide = self._widen(cols)
                for i in range(len(next(iter(wide.values())))):
                    yield {n: v[i] for n, v in wide.items()}

    def fit(
        self,
        train_batches: Callable[[int], Iterator[dict]],
        valid_batches: Callable[[], Iterator[dict]] | None = None,
        *,
        resume: bool = False,
    ) -> list[dict[str, float]]:
        """Host-driven training: ``train_batches(epoch)`` yields the epoch's
        numpy batch dicts (with ``__weight__``), uploaded
        ``steps_per_dispatch`` at a time (``_device_batches``);
        ``valid_batches()`` those of the eval (``evaluate``). Resume, the
        best export, resume points and the history are ``fit_on_device``'s.
        Data-parallel, each rank's iterator yields its own batches, every
        rank as many of as many rows: the global batch is W x batch_size,
        and the logged losses and rows are global."""
        tc = self.exp.train
        self._save_experiment()  # training owns the checkpoint's provenance
        k = max(1, tc.steps_per_dispatch)
        evaluate = None
        if valid_batches is not None:
            evaluate = lambda: self.evaluate(valid_batches())  # noqa: E731
        best, start_epoch = self._resume(resume)
        run_start = len(self.history)
        for epoch in range(start_epoch, tc.epochs):
            t0 = time.perf_counter()
            loss_sum = torch.zeros((), device=self.device)
            n_steps = rows = 0
            with contextlib.closing(self._device_batches(train_batches(epoch), k)) as feed:
                for batch in feed:
                    loss = self.train_step(batch)
                    loss_sum += loss  # on the device: no host read a step
                    n_steps += 1
                    rows += len(batch[self.fm.label]) * self._world
                    if n_steps % tc.log_every == 0:
                        self.log(f"[epoch {epoch + 1}] step {n_steps} loss {float(loss):.4f} "
                                 f"lr {self.schedule(self.state.step - 1):.6f}")
            train_loss = float(loss_sum) / n_steps if n_steps else 0.0
            best = self._close_epoch(epoch, train_loss, rows, time.perf_counter() - t0,
                                     evaluate, best)
        self.log(f"Done. Best {tc.monitor}: {best:.4f}")
        return self.history[run_start:]

    # ------------------------------------------------------------------ eval
    def _prepare_eval_split(self, table, batch_size: int) -> dict:
        """Pad to a whole number of batches (pad rows weigh 0), upload once."""
        n = table.num_rows
        num_batches = max(1, -(-n // batch_size))
        pad = num_batches * batch_size - n
        cols = {}
        for k, v in table.columns.items():
            if pad:
                v = np.concatenate([v, np.zeros((pad, *v.shape[1:]), v.dtype)])
            cols[k] = torch.as_tensor(v).to(self.device)
        weight = torch.cat([torch.ones(n), torch.zeros(pad)]).to(self.device)
        labels = cols.pop(self.fm.label)
        return {"data": cols, "labels": labels, "weight": weight,
                "batch_size": batch_size, "num_batches": num_batches}

    @torch.inference_mode()
    def _eval_probs(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """Eval-mode probabilities of one batch of device columns."""
        feats = {k: v for k, v in batch.items() if k not in (self.fm.label, "__weight__")}
        logits, _ = self.module.apply(
            self.state.params, self.state.model_state, self.fm, self.exp.model,
            self._device_join(feats), train=False, compute_dtype=self.compute_dtype,
            lookup=self.lookup,
        )
        return torch.sigmoid(logits)

    @torch.inference_mode()
    def _predict_prepared(self, prepared: dict) -> torch.Tensor:
        """Eval-mode probabilities of every (padded) row of a prepared split."""
        bs = prepared["batch_size"]
        probs = torch.empty(prepared["num_batches"] * bs, device=self.device)
        for i in range(prepared["num_batches"]):
            batch = {k: v[i * bs : (i + 1) * bs] for k, v in prepared["data"].items()}
            probs[i * bs : (i + 1) * bs] = self._eval_probs(batch)
        return probs

    def _metrics_from(self, labels, probs, weight) -> dict[str, float]:
        """Exact AUC (or histogram AUC with ``num_eval_threshold_bins``) and
        logloss, on the device."""
        nbins = self.exp.train.num_eval_threshold_bins
        if nbins:
            zeros = torch.zeros(nbins, device=probs.device)
            hp, hn = metrics_lib.binned_auc_update(zeros, zeros, labels, probs, weight,
                                                   num_bins=nbins)
            auc_v = metrics_lib.binned_auc_finalize(hp, hn)
        else:
            auc_v = metrics_lib.auc(labels, probs, weight)
        ll = metrics_lib.logloss(labels, probs, weight)
        return {"auc": float(auc_v), "logloss": float(ll)}

    def _evaluate_prepared(self, prepared: dict) -> dict[str, float]:
        probs = self._predict_prepared(prepared)
        return self._metrics_from(prepared["labels"], probs, prepared["weight"])

    def evaluate_table(self, table, batch_size: int | None = None) -> dict[str, float]:
        """AUC/logloss over a TableData split, on the device."""
        prepared = self._prepare_eval_split(table, batch_size or self.exp.train.eval_batch_size)
        return self._evaluate_prepared(prepared)

    def evaluate(self, batches: Iterator[dict]) -> dict[str, float]:
        """AUC/logloss over an iterator of numpy batches (``__weight__`` 0
        rows left out). Exact AUC concatenates every batch's probabilities on
        the device; with ``num_eval_threshold_bins`` the histograms and the
        weighted logloss sums accumulate per batch instead, in constant
        memory."""
        label = self.fm.label
        nbins = self.exp.train.num_eval_threshold_bins
        if not nbins:
            probs_l, labels_l, w_l = [], [], []
            for batch in batches:
                b = self._ready(self.put_batch(batch))
                probs = self._eval_probs(b)
                probs_l.append(probs)
                labels_l.append(b[label])
                w_l.append(b.get("__weight__", torch.ones_like(probs)))
            return self._metrics_from(torch.cat(labels_l), torch.cat(probs_l), torch.cat(w_l))
        hp = torch.zeros(nbins, device=self.device)
        hn = torch.zeros(nbins, device=self.device)
        ll_sum = torch.zeros((), device=self.device)
        w_sum = torch.zeros((), device=self.device)
        for batch in batches:
            b = self._ready(self.put_batch(batch))
            probs = self._eval_probs(b)
            weight = b.get("__weight__", torch.ones_like(probs))
            hp, hn = metrics_lib.binned_auc_update(hp, hn, b[label], probs, weight,
                                                   num_bins=nbins)
            bw = weight.sum()
            # logloss divides by max(sum(w), 1): undo it with the same clamp
            ll_sum = ll_sum + metrics_lib.logloss(b[label], probs, weight) * bw.clamp(min=1.0)
            w_sum = w_sum + bw
        auc_v = metrics_lib.binned_auc_finalize(hp, hn)
        return {"auc": float(auc_v), "logloss": float(ll_sum / w_sum.clamp(min=1.0))}

    def predict(self, batches: Iterator[dict]) -> np.ndarray:
        """Probabilities of the rows of numpy batches, pad rows
        (``__weight__`` 0) dropped."""
        out = []
        for batch in batches:
            probs = self._eval_probs(self._ready(self.put_batch(batch))).cpu().numpy()
            w = np.asarray(batch.get("__weight__", np.ones(len(probs))))
            out.append(probs[w > 0])
        return np.concatenate(out) if out else np.zeros((0,), np.float32)
