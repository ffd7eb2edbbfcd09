"""One rank of the port's data-parallel and row-sharded tests, and the
launcher that starts the ranks: torch.distributed over gloo on the CPU, one
process a rank.

    python tests/_torch_dp_worker.py SPEC.json

The launcher's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``, as torchrun sets them) names the rank;
``parallel.distributed.initialize()`` reads it. SPEC.json lists the cases
to run in order, each ``{"kind": ..., "name": ..., ...}``; a case writes
``<out>/<name>.rank<r>.npz`` (or ``.json``). This module imports neither
JAX nor the JAX package: the tests compare its outputs with the JAX package
in their own process. The tests also call ``port_step``, ``port_bn`` and
``port_tower`` in one process, as the 1-rank reference. Under ``WORLD_SIZE`` = dp x mp ranks a
case whose experiment (or ``mp``) asks for ``model_parallel`` mp runs on the
(dp, mp) mesh: world rank d mp + m holds data rank d and model rank m.
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
              world: int = 1, ckpt: str = "", lookup: dict | None = None
              ) -> dict[str, np.ndarray]:
    """One Trainer step on data rank d's rows [d n/dp, (d + 1) n/dp) of
    ``batch`` from the weights in ``weights`` (a ``jax_bridge.save`` .npz;
    None: the experiment's seeded init); ``rank`` and ``world`` are the
    data rank and dp the mesh must give. ``lookup``: ``make_sharded_lookup``'s
    keywords (default: the Trainer's own lookup). Returns ``loss`` (the
    global loss), ``grad/<target>`` (the global gradients, without the
    gathered tables' row buffers; a rank's shard of a row-sharded table),
    ``clip/<target>`` (the same after the update: clipped, and with
    weight_decay > 0 plus the L2 term), after the update ``param/<path>``,
    ``state/<path>`` and ``topt/<table>/<key>``, and ``coords`` (data rank,
    model rank, dp, mp)."""
    import torch

    from ctr_recommendation_tpu_torch.config import serialize
    from ctr_recommendation_tpu_torch.parallel import distributed
    from ctr_recommendation_tpu_torch.parallel.embedding import make_sharded_lookup
    from ctr_recommendation_tpu_torch.parallel.mesh import make_mesh
    from ctr_recommendation_tpu_torch.tools import jax_bridge
    from ctr_recommendation_tpu_torch.training import Trainer

    exp = serialize.from_json(experiment_json)
    exp = exp.replace(train=dataclasses.replace(exp.train, checkpoint_dir=ckpt))
    params, mstate = jax_bridge.load(weights) if weights else (None, None)
    mesh = make_mesh(exp.mesh, device="cpu")
    fn = None
    if lookup is not None:
        from ctr_recommendation_tpu_torch.features import build_feature_map

        fn = make_sharded_lookup(mesh, feature_map=build_feature_map(exp.dataset), **lookup)
    tr = Trainer(exp, mesh=mesh, params=params, model_state=mstate, device="cpu",
                 total_steps=10, lookup=fn, log_fn=lambda s: None)
    dp, d = tr._world, mesh.data_rank
    assert (d, dp) == (rank, world), (d, dp, rank, world)
    n = len(batch["label"]) // dp
    cols, row0 = distributed.host_local_to_global(
        {k: v[d * n : (d + 1) * n] for k, v in batch.items()}, tr.mesh)
    assert row0 == d * n, (row0, d, n)
    with torch.enable_grad():
        loss, aux = tr.forward_loss(cols)
        grads = tr.gradients(loss, aux)
    out = {"loss": _np(aux.loss),
           "coords": np.array([d, mesh.model_rank, dp, mesh.shape["model"]])}
    out.update({f"grad/{k}": _np(g) for k, g in zip(aux.targets, grads)
                if not k.startswith("rows/")})
    tr.apply_gradients(grads, aux)
    out.update({f"clip/{k}": _np(g) for k, g in zip(aux.targets, grads)
                if not k.startswith("rows/")})
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


def port_tower(weighted: bool, rank: int = 0, world: int = 1) -> dict[str, np.ndarray]:
    """One tower layer on ``ops/cuda/tower.py::TowerLayer`` (its plain
    blocks, on the CPU) over rows [rank n/world, (rank + 1) n/world) of 64
    seeded rows of y, BatchNorm and dropout 0.2 on, the ranks' sums
    all-reduced between the blocks when world > 1: the rank's outputs and
    dy, the new running statistics and the (global) gradients of b, gamma
    and beta of sum(out * c), c seeded."""
    import torch

    from ctr_recommendation_tpu_torch.ops.cuda import tower
    from ctr_recommendation_tpu_torch.parallel import data_parallel

    rng = np.random.default_rng(5)
    n, width = 64, 24
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    y = f32(rng.standard_normal((n, width)) * 1.5 + 0.3)
    u = f32(rng.random((n, width)))
    c = f32(rng.standard_normal((n, width)))
    weight = f32(rng.random(n) < 0.7) if weighted else None
    params = [f32(rng.standard_normal(width) * 0.5), f32(1 + 0.2 * rng.standard_normal(width)),
              f32(0.2 * rng.standard_normal(width))]
    run_mean, run_var = f32(rng.normal(0, 0.3, width)), f32(rng.uniform(0.5, 2.0, width))
    for t in params:
        t.requires_grad_()
    m = n // world
    rows = slice(rank * m, (rank + 1) * m)
    ys = y[rows].clone().requires_grad_()
    group = None
    if world > 1:
        import torch.distributed as dist

        group = dist.group.WORLD
    out, running = tower.TowerLayer.apply(
        ys, *params, u[rows], None if weight is None else weight[rows], run_mean, run_var, 0.8,
        group)
    grads = list(torch.autograd.grad((out * c[rows]).sum(), [ys, *params]))
    if group is not None:
        data_parallel.all_reduce_buckets_(grads[1:], group)
    return {"out": _np(out), "dy": _np(grads[0]), "db": _np(grads[1]),
            "dgamma": _np(grads[2]), "dbeta": _np(grads[3]), "running": _np(running)}


def port_fit(experiment_json: str, splits: str, ckpt: str, world: int = 1) -> list[dict]:
    """``fit_on_device`` over the splits in ``splits`` (an .npz of train/,
    valid/ columns and the item store), on this process's mesh (dp =
    ``world``); returns the history."""
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


# ------------------------------------------------------ row-sharded lookups
LOOKUP_STATS = ("calls", "bytes", "row_bytes", "fallbacks")


def lookup_scenarios() -> list[dict]:
    """The lookups the sharded-lookup tests run, numpy only: each a whole
    ``table`` (V, E), a global batch of ``ids`` (split over the data ranks
    on axis 0), the ``method``, ``cap`` (capacity factor), ``pad`` (pad id),
    ``loss`` ("x2": sum(2 rows), "sq": sum(rows^2)) and ``via`` ("direct":
    ``sharded_lookup``; "make": ``make_sharded_lookup`` of the tiny feature
    map with ``small`` small_table_rows, looking up ``table_name``)."""
    out = []
    rng = np.random.default_rng(11)
    v = 256  # round_up_vocab(200)
    table = rng.standard_normal((v, 16)).astype(np.float32)
    padded = table.copy()
    padded[0] = 0.0  # the pad row, zeroed at init
    ids_pad = np.where(rng.random((64, 8)) < 0.5, 0,
                       rng.integers(1, 200, (64, 8))).astype(np.int32)
    small = rng.standard_normal((128, 16)).astype(np.float32)
    for method in ("psum", "all_to_all"):
        base = dict(table=table, method=method, cap=1.25, pad=None, loss="x2", via="direct")
        out += [
            dict(base, name=f"flat_{method}", ids=rng.integers(0, 200, (64,)).astype(np.int32)),
            dict(base, name=f"seq_{method}", ids=rng.integers(0, 200, (64, 5)).astype(np.int32)),
            dict(base, name=f"skew_{method}", ids=np.full((64, 5), 3, np.int32), cap=1.1),
            dict(base, name=f"range_{method}",
                 ids=np.asarray([3, -1, v, 7, v + 99, 5, 2, 1], np.int32)),
            dict(base, name=f"repeat_{method}", ids=np.asarray([3, 3, 7, 99], np.int32)),
            dict(base, name=f"pad_{method}", table=padded, ids=ids_pad,
                 pad=0 if method == "all_to_all" else None, loss="sq"),
        ]
    out += [
        dict(name="fallback_grad", table=table, ids=np.full((32,), 5, np.int32),
             method="all_to_all", cap=1.1, pad=None, loss="sq", via="direct"),
        dict(name="small_passthrough", table=small, table_name="likes_level",
             ids=np.asarray([0, 5, 10, 3, 127, 64, 9, 1], np.int32), method="all_to_all",
             cap=1.25, pad=None, loss="x2", via="make", small=1024),
        dict(name="fm_pad", table=padded, table_name="item_id", ids=ids_pad,
             method="all_to_all", cap=1.25, pad=0, loss="sq", via="make", small=0),
        # the bytes: 1024 ids of E=128, balanced over the owners
        dict(name="bytes_psum", table=rng.standard_normal((1024, 128)).astype(np.float32),
             ids=rng.integers(0, 1024, (1024,)).astype(np.int32), method="psum", cap=1.25,
             pad=None, loss="x2", via="direct"),
    ]
    out.append(dict(out[-1], name="bytes_all_to_all", method="all_to_all"))
    return out


def _lookups(case, rank, world):
    """Every ``lookup_scenarios()`` lookup on the (world / mp, mp) mesh: this
    rank's rows, its shard's gradient (summed over the data group) and the
    exchange's counters."""
    import torch
    import torch.distributed as dist

    from ctr_recommendation_tpu_torch.config.schema import MeshConfig
    from ctr_recommendation_tpu_torch.features import build_feature_map
    from ctr_recommendation_tpu_torch.parallel import embedding, make_mesh

    mesh = make_mesh(MeshConfig(model_parallel=case["mp"]), device="cpu")
    dp, mp, d, m = mesh.shape["data"], mesh.shape["model"], mesh.data_rank, mesh.model_rank
    fm = build_feature_map(_tiny_port_experiment().dataset)
    out = {"coords": np.array([d, m, dp, mp])}
    for sc in lookup_scenarios():
        rows_per = sc["table"].shape[0] // mp
        shard = torch.from_numpy(sc["table"][m * rows_per : (m + 1) * rows_per].copy())
        shard.requires_grad_()
        ids = torch.from_numpy(np.array_split(sc["ids"], dp)[d].copy())
        embedding.stats.update(dict.fromkeys(LOOKUP_STATS, 0))
        if sc["via"] == "make":
            fn = embedding.make_sharded_lookup(mesh, feature_map=fm, small_table_rows=sc["small"],
                                               method=sc["method"], capacity_factor=sc["cap"])
            rows = fn({sc["table_name"]: shard}, sc["table_name"], ids)
        else:
            rows = embedding.sharded_lookup(shard, ids, mesh, method=sc["method"],
                                            capacity_factor=sc["cap"], pad_id=sc["pad"])
        stats = [embedding.stats[k] for k in LOOKUP_STATS]
        loss = (rows * 2.0).sum() if sc["loss"] == "x2" else (rows**2).sum()
        (grad,) = torch.autograd.grad(loss, [shard])
        if dp > 1:
            dist.all_reduce(grad, group=mesh.group("data"))
        out[f"{sc['name']}/rows"] = _np(rows)
        out[f"{sc['name']}/grad"] = _np(grad)
        out[f"{sc['name']}/stats"] = np.asarray(stats)
    return out


def _tiny_port_experiment():
    """The port's counterpart of tests/conftest.py's tiny experiment."""
    from ctr_recommendation_tpu_torch.config import microlens_experiment
    from ctr_recommendation_tpu_torch.config.loader import microlens_features

    exp = microlens_experiment(data_root="", embedding_dim=16, hidden_units=(32, 16),
                               batch_size=64, epochs=2, max_len=8, use_pallas=False)
    return exp.replace(dataset=dataclasses.replace(exp.dataset, features=microlens_features(
        item_vocab=200, cate_vocab=11, max_len=8, mm_dim=24)))


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
    for name, cfg in (("dp3", MeshConfig(data_parallel=3)),):
        try:
            make_mesh(cfg, device="cpu")
        except ValueError as e:
            errors[name] = f"{type(e).__name__}: {e}"
    out["errors"] = errors
    mp2 = make_mesh(MeshConfig(model_parallel=2), device="cpu")
    out["mp2"] = {"shape": mp2.shape, "data_rank": mp2.data_rank,
                  "model_rank": mp2.model_rank, "writes": mp2.writes}
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
    ranks. On the 1 x 2 mesh a Trainer keeps its shard of each table (its
    moments too, and the sparse table optimizers' state), and raises on
    every rank when a shard differs across its data group (here: never,
    dp = 1) or a replicated leaf across the model group."""
    from ctr_recommendation_tpu_torch.config import serialize
    from ctr_recommendation_tpu_torch.config.schema import MeshConfig
    from ctr_recommendation_tpu_torch.data import TableData
    from ctr_recommendation_tpu_torch.parallel import make_mesh
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
    mesh = make_mesh(MeshConfig(model_parallel=2), device="cpu")
    tr = Trainer(exp, mesh=mesh, params=params, model_state=mstate, device="cpu",
                 log_fn=lambda s: None)
    out["mp2_shapes"] = {k: list(v.shape) for k, v in tr.param_paths.items()
                         if k.startswith("trunk/tables/")}
    out["mp2_moment"] = list(tr.state.opt_state["mu"][
        tr._chain_paths.index("trunk/tables/item_id")].shape)
    out["mp2_writes"] = tr._writes
    sparse = exp.replace(train=dataclasses.replace(exp.train, table_optimizer="adam"))
    st = Trainer(sparse, mesh=mesh, params=params, model_state=mstate, device="cpu",
                 log_fn=lambda s: None).state.table_opt_state
    out["mp2_sparse"] = {f"{t}/{k}": list(v.shape) for t, d in st.items() for k, v in d.items()}
    w00 = params["mlp"]["out"]["w"][0, 0].copy()
    if rank == 1:
        params["mlp"]["out"]["w"][0, 0] += 1e-3
    try:
        Trainer(exp, mesh=mesh, params=params, model_state=mstate, device="cpu",
                log_fn=lambda s: None)
    except ValueError as e:
        out["mp2_replica"] = str(e)
    if rank == 1:
        params["mlp"]["out"]["w"][0, 0] = w00
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
            mp = case.get("mp", 1)
            res = port_step(case["experiment"], case["weights"], dict(np.load(case["batch"])),
                            rank // mp, world // mp, case["ckpt"] + str(rank),
                            lookup=case.get("lookup"))
        elif kind == "bn":
            res = port_bn(case["weighted"], rank, world)
        elif kind == "tower":
            res = port_tower(case["weighted"], rank, world)
        elif kind == "fit":
            mp = case.get("mp", 1)
            res = port_fit(case["experiment"], case["splits"],
                           case["ckpt"] + (str(rank) if mp > 1 else ""), world // mp)
        elif kind == "lookup":
            res = _lookups(case, rank, world)
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
