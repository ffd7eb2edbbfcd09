"""Sharding rules for the train state and batches: the JAX package's
``parallel/sharding.py`` on the port's trees.

A ``PartitionSpec`` names, for each dimension of a tensor, the mesh axis it
is split over (None: whole). Embedding tables
(``params["trunk"]["tables"][*]``) are row-sharded P(model_axis, None) only
when the model axis has more than one rank; every other parameter is
replicated; batches are split P(data_axis) on their row dimension, each rank
holding its own rows. Optimizer state takes the specs of the leaves it
mirrors.

The port has no global arrays: a rank holds its shard of each
row-sharded table (``shard_rows``) and a replica of everything else;
``unshard_rows`` gathers a table whole again (for a checkpoint), and
``put_global`` checks once that the ranks hold what the specs say.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from ctr_recommendation_tpu_torch.parallel.mesh import Mesh
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


def shard_rows(full: torch.Tensor, mesh: Mesh, model_axis: str = "model") -> torch.Tensor:
    """This rank's rows of a P(model, None) table, [m V/mp, (m + 1) V/mp)
    for model rank m (a copy)."""
    mp = mesh.shape[model_axis]
    if full.shape[0] % mp:
        raise ValueError(f"table rows {full.shape[0]} not divisible by model-parallel degree "
                         f"{mp}; pad with round_up_vocab()")
    rows = full.shape[0] // mp
    m = mesh.rank(model_axis)
    return full[m * rows : (m + 1) * rows].clone()


def unshard_rows(shard: torch.Tensor, mesh: Mesh, model_axis: str = "model") -> torch.Tensor:
    """The whole table from every model rank's shard (an all-reduce of a
    zeroed (mp, rows, ...) buffer over the model group; every rank of the
    group must call it)."""
    mp = mesh.shape[model_axis]
    if mp == 1:
        return shard
    buf = shard.new_zeros((mp, *shard.shape))
    buf[mesh.rank(model_axis)] = shard
    dist.all_reduce(buf, group=mesh.group(model_axis))
    return buf.reshape(-1, *shard.shape[1:])


def _check_equal(leaves: list[torch.Tensor], mesh: Mesh, axis: str, what: str) -> None:
    """Raise on every rank of ``axis``' group unless each holds the group's
    rank 0's ``leaves`` (flattened into one fp64 buffer, broadcast)."""
    group = mesh.group(axis)
    world = dist.get_world_size(group)
    if world == 1 or not leaves:
        return
    mine = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in leaves])
    ref = mine.clone()
    dist.broadcast(ref, dist.get_global_rank(group, 0), group=group)
    differs = torch.zeros(world, dtype=torch.float64, device=mine.device)
    differs[mesh.rank(axis)] = float(not torch.equal(mine, ref))
    dist.all_reduce(differs, group=group)
    bad = [r for r in range(world) if differs[r] != 0]
    if bad:
        raise ValueError(
            f"the {what} of {axis} rank(s) {bad} differ from rank 0's: every rank must "
            "initialise from the same seed (or load the same weights)")


def put_global(tree: Any, shardings: Any) -> Any:
    """Check that every rank holds what ``shardings`` say of ``tree``
    (tensors on the rank's device, shards already cut by ``shard_rows``) and
    return it.

    JAX builds the global arrays from each process's host values and relies
    on every process initialising from the same seed. The port's ranks each
    keep their own replicas and shards, so it checks that contract once:
    each replicated leaf equal on all ranks (across the data group, then
    across the model group), each shard equal across its data group (the
    ranks of one model rank); every rank raises when any rank differs."""
    leaves = tree_leaves(tree)
    specs = tree_leaves(shardings)
    mesh = specs[0].mesh if specs else None
    if mesh is None or mesh.device_mesh is None or not leaves:
        return tree
    data_axis, model_axis = mesh.axis_names
    replicated = [t for t, s in zip(leaves, specs) if s.spec == P()]
    sharded = [t for t, s in zip(leaves, specs) if s.spec != P()]
    if any(s.spec not in (P(), P(model_axis, None)) for s in specs):
        raise ValueError(f"unsupported specs {sorted({tuple(s.spec) for s in specs})}")
    _check_equal(replicated, mesh, data_axis, "replicated parameters")
    _check_equal(replicated, mesh, model_axis, "replicated parameters")
    _check_equal(sharded, mesh, data_axis, "table shards")
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
