"""Sharding rules for the train state and batches: the JAX package's
``parallel/sharding.py`` on the port's trees.

A ``PartitionSpec`` names, for each dimension of a tensor, the mesh axis it
is split over (None: whole). Embedding tables
(``params["trunk"]["tables"][*]``) are row-sharded P(model_axis, None) only
when the model axis has more than one rank; every other parameter is
replicated; batches are split P(data_axis) on their row dimension, each rank
holding its own rows. Optimizer state takes the specs of the leaves it
mirrors.

Only replicated parameters are ported (``make_mesh`` refuses model > 1):
``put_global`` checks them across the ranks once.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from ctr_recommendation_tpu_torch.parallel.mesh import MODEL_PARALLEL_REFUSAL, Mesh
from ctr_recommendation_tpu_torch.utils.tree import tree_leaves


class PartitionSpec(tuple):
    """Per dimension, the mesh axis it is split over (None: not split);
    ``P()`` is replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: PartitionSpec


def batch_sharding(mesh: Mesh, data_axis: str = "data") -> NamedSharding:
    return NamedSharding(mesh, P(data_axis))


def batch_specs(batch: dict, data_axis: str = "data") -> dict:
    return {k: P(data_axis) for k in batch}


def param_specs(params: Any, mesh: Mesh, model_axis: str = "model") -> Any:
    """PartitionSpec tree matching the params tree: tables row-sharded iff
    the model axis has >1 rank, all else replicated."""
    shard_tables = mesh.shape[model_axis] > 1

    def walk(tree, in_tables: bool):
        if isinstance(tree, dict):
            return {k: walk(v, in_tables or k == "tables") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, in_tables) for v in tree)
        if in_tables and shard_tables and getattr(tree, "ndim", 0) == 2:
            return P(model_axis, None)
        return P()

    return walk(params, False)


def tree_shardings(spec_tree: Any, mesh: Mesh) -> Any:
    if isinstance(spec_tree, PartitionSpec):
        return NamedSharding(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: tree_shardings(v, mesh) for k, v in spec_tree.items()}
    return type(spec_tree)(tree_shardings(v, mesh) for v in spec_tree)


def put_global(tree: Any, shardings: Any) -> Any:
    """Check that every rank holds rank 0's values of ``tree`` (tensors on
    the rank's device) and return it.

    JAX builds the global arrays from each process's host values and relies
    on every process initialising from the same seed. The port's ranks each
    keep their own replica, so it checks that contract once: rank 0's
    leaves, flattened into one fp64 buffer, are broadcast over the data
    group and compared; every rank raises when any rank differs."""
    leaves = tree_leaves(tree)
    specs = tree_leaves(shardings)
    if any(s.spec != P() for s in specs):
        raise NotImplementedError(MODEL_PARALLEL_REFUSAL)
    mesh = specs[0].mesh if specs else None
    group = None if mesh is None else mesh.group(mesh.axis_names[0])
    if group is None or not leaves:
        return tree
    mine = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in leaves])
    ref = mine.clone()
    dist.broadcast(ref, dist.get_global_rank(group, 0), group=group)
    world = dist.get_world_size(group)
    differs = torch.zeros(world, dtype=torch.float64, device=mine.device)
    differs[mesh.data_rank] = float(not torch.equal(mine, ref))
    dist.all_reduce(differs, group=group)
    bad = [r for r in range(world) if differs[r] != 0]
    if bad:
        raise ValueError(
            f"the replicated parameters of data rank(s) {bad} differ from rank 0's: every rank "
            "must initialise from the same seed (or load the same weights)")
    return tree


def opt_state_specs(opt_state: Any, params_spec_tree: Any, params: Any) -> Any:
    """Give optimizer-state subtrees that mirror the params tree (the dense
    chain's Adam ``mu``/``nu`` or Adagrad ``sum_of_squares`` lists, the
    table optimizer's per-table state) the param specs, and replicate every
    other leaf (step counters etc.)."""

    def shape_of(tree):
        if isinstance(tree, dict):
            return {k: shape_of(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [shape_of(v) for v in tree]
        return tuple(tree.shape) if hasattr(tree, "shape") else None

    want = shape_of(params)

    def rec(node: Any) -> Any:
        if shape_of(node) == want:
            return params_spec_tree
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(c) for c in node)
        return P()

    return rec(opt_state)
