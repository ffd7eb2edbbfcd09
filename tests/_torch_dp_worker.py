"""One rank of the port's data-parallel tests, and the launcher that starts
the ranks: torch.distributed over gloo on the CPU, one process a rank.

    python tests/_torch_dp_worker.py SPEC.json

The launcher's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``, as torchrun sets them) names the rank;
``parallel.distributed.initialize()`` reads it. SPEC.json lists the cases
to run in order, each ``{"kind": ..., "name": ..., ...}``; a case writes
``<out>/<name>.rank<r>.npz`` (or ``.json``). This module imports neither
JAX nor the JAX package: the tests compare its outputs with the JAX package
in their own process. The tests also call ``port_step`` and ``port_bn`` in
one process, as the 1-rank reference.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TIMEOUT_S = 120  # the whole spawn's limit; the ranks are killed past it


# ------------------------------------------------------------------ launcher
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(cases: list[dict], out_dir: str, world: int = WORLD,
              timeout: float = TIMEOUT_S) -> list[str]:
    """Start ``world`` ranks on ``cases`` and wait for all of them, killing
    every rank at ``timeout``; raise unless all exit 0. Returns each rank's
    output."""
    os.makedirs(out_dir, exist_ok=True)
    spec = os.path.join(out_dir, "spec.json")
    with open(spec, "w") as f:
        json.dump({"out": out_dir, "cases": cases}, f)
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        env.pop("JAX_PLATFORMS", None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), spec], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            os.killpg(p.pid, signal.SIGKILL)
        raise AssertionError(f"the {world} ranks did not finish in {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{out}"
    return outs


def load(out_dir: str, name: str, rank: int = 0) -> dict:
    path = os.path.join(out_dir, f"{name}.rank{rank}")
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            return json.load(f)
    with np.load(path + ".npz") as z:
        return {k: z[k] for k in z.files}


# --------------------------------------------------------------- shared cases
def _np(t):
    """A copy (the optimizer updates gradients and parameters in place)."""
    return t.detach().cpu().numpy().copy() if hasattr(t, "detach") else np.array(t)


def port_step(experiment_json: str, weights: str, batch: dict, rank: int = 0,
              world: int = 1, ckpt: str = "") -> dict[str, np.ndarray]:
    """One Trainer step on rows [rank n/world, (rank + 1) n/world) of
    ``batch`` from the weights in ``weights`` (a ``jax_bridge.save`` .npz;
    None: the experiment's seeded init):
    ``loss`` (the global loss), ``grad/<target>`` (the global gradients,
    without the gathered tables' row buffers), and after the update
    ``param/<path>``, ``state/<path>`` and ``topt/<table>/<key>``."""
    import torch

    from ctr_recommendation_tpu_torch.config import serialize
    from ctr_recommendation_tpu_torch.parallel import distributed
    from ctr_recommendation_tpu_torch.tools import jax_bridge
    from ctr_recommendation_tpu_torch.training import Trainer

    exp = serialize.from_json(experiment_json)
    exp = exp.replace(train=dataclasses.replace(exp.train, checkpoint_dir=ckpt))
    params, mstate = jax_bridge.load(weights) if weights else (None, None)
    tr = Trainer(exp, params=params, model_state=mstate, device="cpu", total_steps=10,
                 log_fn=lambda s: None)
    n = len(batch["label"]) // world
    cols, row0 = distributed.host_local_to_global(
        {k: v[rank * n : (rank + 1) * n] for k, v in batch.items()}, tr.mesh)
    assert row0 == rank * n, (row0, rank, n)
    with torch.enable_grad():
        loss, aux = tr.forward_loss(cols)
        grads = tr.gradients(loss, aux)
    out = {"loss": _np(aux.loss)}
    out.update({f"grad/{k}": _np(g) for k, g in zip(aux.targets, grads)
                if not k.startswith("rows/")})
    tr.apply_gradients(grads, aux)
    out.update({f"param/{k}": _np(v) for k, v in jax_bridge.flatten(tr.state.params).items()})
    out.update({f"state/{k}": _np(v)
                for k, v in jax_bridge.flatten(tr.state.model_state).items()})
    out.update({f"topt/{k}": _np(v)
                for k, v in jax_bridge.flatten(tr.state.table_opt_state).items()})
    return out


def port_bn(weighted: bool, rank: int = 0, world: int = 1) -> dict[str, np.ndarray]:
    """A two-layer BatchNorm tower in train mode over rows [rank n/world,
    (rank + 1) n/world) of 64 seeded rows, inside a data-parallel step's
    slice when world > 1: the outputs and input gradients of the rank's
    rows, the new running statistics and the (global) parameter gradients
    of sum(out * c), c seeded."""
    import torch

    from ctr_recommendation_tpu_torch.ops import mlp
    from ctr_recommendation_tpu_torch.parallel import data_parallel
    from ctr_recommendation_tpu_torch.tools import jax_bridge

    rng = np.random.default_rng(3)
    n = 64
    x = rng.standard_normal((n, 48)).astype(np.float32) * 2 + 0.5
    c = rng.standard_normal((n, 1)).astype(np.float32)
    weight = (rng.random(n) < 0.7).astype(np.float32) if weighted else None
    params, state = mlp.init(torch.Generator().manual_seed(0), 48, [32, 16])
    for st in state["layers"]:
        d = st["bn_mean"].shape
        st["bn_mean"] = torch.from_numpy(rng.normal(0, 0.3, d).astype(np.float32))
        st["bn_var"] = torch.from_numpy(rng.uniform(0.5, 2.0, d).astype(np.float32))
    leaves = list(jax_bridge.flatten(params).values())
    for t in leaves:
        t.requires_grad_()
    m = n // world
    rows = slice(rank * m, (rank + 1) * m)
    xs = torch.from_numpy(x[rows]).requires_grad_()
    ws = None if weight is None else torch.from_numpy(weight[rows])
    data = None
    if world > 1:
        import torch.distributed as dist

        data = data_parallel.DataSlice(dist.group.WORLD, world, rank, m)
    with data_parallel.step_slice(data):
        out, new_state = mlp.apply(params, state, xs, train=True, weight=ws)
    share = (out * torch.from_numpy(c[rows])).sum()
    grads = list(torch.autograd.grad(share, [xs, *leaves]))
    if data is not None:
        data_parallel.all_reduce_buckets_(grads[1:], data.group)
    res = {"out": _np(out), "dx": _np(grads[0])}
    res.update({f"grad/{k}": _np(g) for k, g in zip(jax_bridge.flatten(params), grads[1:])})
    res.update({f"state/{k}": _np(v) for k, v in jax_bridge.flatten(new_state).items()})
    return res


def port_fit(experiment_json: str, splits: str, ckpt: str, world: int = 1) -> list[dict]:
    """``fit_on_device`` over the splits in ``splits`` (an .npz of train/,
    valid/ columns and the item store), on this process's mesh; returns the
    history."""
    from ctr_recommendation_tpu_torch.config import serialize
    from ctr_recommendation_tpu_torch.data import ItemStore, TableData
    from ctr_recommendation_tpu_torch.training import Trainer

    exp = serialize.from_json(experiment_json)
    exp = exp.replace(train=dataclasses.replace(exp.train, checkpoint_dir=ckpt))
    with np.load(splits) as z:
        cols = {k: z[k] for k in z.files}
    train = {k[6:]: v for k, v in cols.items() if k.startswith("train/")}
    valid = {k[6:]: v for k, v in cols.items() if k.startswith("valid/")}
    n_train, n_valid = len(train["label"]), len(valid["label"])
    tr = Trainer(exp, steps_per_epoch=n_train // exp.train.batch_size, device="cpu",
                 item_store=ItemStore.from_arrays(cols["item_ids"], cols["item_emb"]),
                 log_fn=lambda s: None)
    assert tr._world == world
    return tr.fit_on_device(TableData(train, n_train), TableData(valid, n_valid))


# ------------------------------------------------------------------ the rank
def _runtime(case, rank, world):
    """initialize from the environment (idempotent), the rank's id and
    count, make_mesh's layouts and refusals, host_local_to_global's offsets,
    and the counterpart of the JAX package's two-process global loss."""
    import torch

    from ctr_recommendation_tpu_torch.config.schema import MeshConfig
    from ctr_recommendation_tpu_torch.parallel import data_parallel, distributed, make_mesh

    out = {"again": distributed.initialize(), "host_id": distributed.host_id(),
           "host_count": distributed.host_count()}
    mesh = make_mesh(device="cpu")
    out["mesh_shape"] = mesh.shape
    out["data_rank"] = mesh.data_rank
    errors = {}
    for name, cfg in (("dp3", MeshConfig(data_parallel=3)),
                      ("mp2", MeshConfig(model_parallel=2))):
        try:
            make_mesh(cfg, device="cpu")
        except (ValueError, NotImplementedError) as e:
            errors[name] = f"{type(e).__name__}: {e}"
    out["errors"] = errors
    rng = np.random.default_rng(0)
    _, row0 = distributed.host_local_to_global({"a": rng.random((5, 3))}, mesh)
    _, row0_k = distributed.host_local_to_global({"a": rng.random((4, 6, 3))}, mesh, batch_dim=1)
    out["row0"], out["row0_k"] = row0, row0_k
    # tests/test_distributed.py's global loss: mean(emb[ids].sum(-1) * y)
    rng = np.random.default_rng(0)
    n, vocab, e = 64, 32, 8
    ids = rng.integers(0, vocab, size=(n,)).astype(np.int32)
    y = rng.normal(size=(n,)).astype(np.float32)
    emb = torch.from_numpy(rng.normal(size=(vocab, e)).astype(np.float32)).requires_grad_()
    m = n // world
    local, _ = distributed.host_local_to_global(
        {"ids": ids[rank * m : (rank + 1) * m], "y": y[rank * m : (rank + 1) * m]}, mesh)
    share = (emb[local["ids"].long()].sum(-1) * local["y"]).sum() / n
    (grad,) = torch.autograd.grad(share, [emb])
    loss = share.detach().reshape(1).clone()
    data_parallel.all_reduce_buckets_([grad, loss], mesh.group("data"))
    out["loss"], out["gnorm"] = float(loss[0]), float(torch.linalg.vector_norm(grad))
    return out


def _refusals(case, rank, world):
    """A Trainer whose replica differs on rank 1 must raise on every rank;
    ``fit_on_device`` refuses a global batch that does not divide over the
    ranks."""
    from ctr_recommendation_tpu_torch.config import serialize
    from ctr_recommendation_tpu_torch.data import TableData
    from ctr_recommendation_tpu_torch.tools import jax_bridge
    from ctr_recommendation_tpu_torch.training import Trainer

    exp = serialize.from_json(case["experiment"])
    exp = exp.replace(train=dataclasses.replace(exp.train, checkpoint_dir=case["ckpt"],
                                                batch_size=63))
    params, mstate = jax_bridge.load(case["weights"])
    out = {}
    tr = Trainer(exp, params=params, model_state=mstate, device="cpu", log_fn=lambda s: None)
    try:
        tr.fit_on_device(TableData({"label": np.zeros(200, np.float32)}, 200))
    except ValueError as e:
        out["batch"] = str(e)
    if rank == 1:
        params["trunk"]["tables"]["item_id"][3, 2] += 1e-3
    try:
        Trainer(exp, params=params, model_state=mstate, device="cpu", log_fn=lambda s: None)
    except ValueError as e:
        out["replica"] = str(e)
    return out


def main() -> None:
    import torch

    torch.set_num_threads(1)
    from ctr_recommendation_tpu_torch.parallel import distributed

    with open(sys.argv[1]) as f:
        spec = json.load(f)
    assert distributed.initialize(timeout_s=TIMEOUT_S)
    rank, world = distributed.host_id(), distributed.host_count()
    for case in spec["cases"]:
        kind, path = case["kind"], os.path.join(spec["out"], f"{case['name']}.rank{rank}")
        if kind == "step":
            if case.get("gathered_ratio") is not None:
                from ctr_recommendation_tpu_torch.training import sparse

                sparse.GATHERED_MIN_VOCAB_RATIO = case["gathered_ratio"]
            res = port_step(case["experiment"], case["weights"], dict(np.load(case["batch"])),
                            rank, world, case["ckpt"] + str(rank))
        elif kind == "bn":
            res = port_bn(case["weighted"], rank, world)
        elif kind == "fit":
            res = port_fit(case["experiment"], case["splits"], case["ckpt"], world)
        elif kind == "runtime":
            res = _runtime(case, rank, world)
        elif kind == "refusals":
            res = _refusals(case, rank, world)
        elif kind == "cli":
            from ctr_recommendation_tpu_torch.cli.train import main as train_main

            res = {"rc": train_main(case["argv"])}
        else:
            raise ValueError(f"unknown case kind {kind!r}")
        if isinstance(res, dict) and all(isinstance(v, np.ndarray) for v in res.values()):
            np.savez(path + ".npz", **res)
        else:
            with open(path + ".json", "w") as f:
                json.dump(res, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
