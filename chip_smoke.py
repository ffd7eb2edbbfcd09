#!/usr/bin/env python3
"""Drive the PyTorch port (ctr_recommendation_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line.

1. Print the card's name and power limit (nvidia-smi), build both kernels
   from csrc/ with nvcc for sm_90a, one nvcc per source in parallel.
2. With TF32 off, hold each kernel against its plain PyTorch version at full
   width (B=8192 and a ragged 8192+37, F=6, E=128, tower 2688->512->256->1,
   "all" and "each", bf16 and fp32).
3. Time each kernel and its plain version with CUDA events (median of 30
   after warm-up) beside the bound the card sets for the same work.
4. The serving main path at the full microlens_experiment() defaults
   (mm_fibinet, E=128, item vocab 91718, max_len 20, hidden (512, 256),
   bf16): seeded weights with perturbed BatchNorm stats, a seeded item
   store, 385,024 rows (47 x 8192) made with numpy; Predictor.score_table,
   then run_submission_pipeline from numpy chunks. Checks the CSV, the exact
   agreement of the two paths, the first 8192 rows against the same
   Predictor on the CPU, and the scoring kernel's launch count on each path.
5. The unfused branch (fold_bn=False) for a few batches: the interaction
   kernel runs and agrees with the fused branch.
6. One JSON line describing both kernels, then the result line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

B_FULL = 8192
B_RAGGED = 8192 + 37
F, E = 6, 128
HIDDEN = (512, 256)
N_ROWS = 47 * 8192  # the reference test split's size
CHUNK_ROWS = 65_536
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor / fp32 FMA
# kernel vs its plain version on the card: (atol, rtol). fp32 differs only by
# summation order; in bf16 a rounding point can land one ulp apart when the
# fp32 sums feeding it are taken in another order, and an interaction pair
# product carries two such roundings.
TOL = {
    ("interaction_fwd", "float32"): (1e-5, 1e-5),
    ("interaction_fwd", "bfloat16"): (1e-3, 2.0**-6),
    ("fused_score", "float32"): (2e-5, 0.0),
    ("fused_score", "bfloat16"): (5e-3, 0.0),
}
CPU_TOL = 2e-2  # card vs CPU run of the same bf16 Predictor (probabilities)


def log(msg: str) -> None:
    print(msg, flush=True)


def kernel_inputs(torch, btype: str, dtype, b: int, seed: int):
    """Full-width operands for both kernels, drawn with the port's own
    initializers from a seeded generator; x from numpy."""
    from ctr_recommendation_tpu_torch.ops import bilinear, mlp, senet
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import senet_weights

    gen = torch.Generator().manual_seed(seed)
    x = np.random.default_rng(seed).standard_normal((b, F, E)).astype(np.float32)
    sp = senet.init(gen, F, 2)
    bp = bilinear.init(gen, E, F, btype)
    cdim = (F + F * (F - 1) // 2) * E
    mp, _ = mlp.init(gen, cdim, HIDDEN, batch_norm=False)
    dev = "cuda"
    sw = [t.to(dev) for t in senet_weights(sp, F)]
    w_bi = (bp["w"] if btype == "all" else bp["w_each"]).to(dev, dtype).contiguous()
    tower = []
    for lin in (mp["layers"][0]["linear"], mp["layers"][1]["linear"], mp["out"]):
        tower += [lin["w"].to(dev, dtype).contiguous(), lin["b"].to(dev)]
    xt = torch.from_numpy(x).to(dev, dtype)
    return xt, sw, w_bi, tower


def check_close(name, got, want, dtype_name):
    atol, rtol = TOL[(name, dtype_name)]
    err = (got.double() - want.double()).abs()
    bad = (err > atol + rtol * want.double().abs()).sum().item()
    return err.max().item(), bad, f"|d| <= {atol:g} + {rtol:g}*|want|"


def time_ms(torch, fn, reps: int = 30) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event-timed runs."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    return float(np.median(times))


def make_rows(n: int, seed: int) -> dict[str, np.ndarray]:
    """MicroLens-shaped test rows: left-padded histories of 0..20 items."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 21, n)
    seq = rng.integers(1, 91718, (n, 20)).astype(np.int32)
    seq[np.arange(20)[None, :] < (20 - lens)[:, None]] = 0
    return {
        "user_id": rng.integers(0, 20000, n).astype(np.int32),
        "likes_level": rng.integers(0, 11, n).astype(np.int32),
        "views_level": rng.integers(0, 11, n).astype(np.int32),
        "item_id": rng.integers(1, 91718, n).astype(np.int32),
        "item_seq": seq,
    }


def where_the_time_goes(torch, pred, rows, bulk, card) -> None:
    """Per-batch device split of the fused scoring step (CUDA events) and
    the pipeline's host stages over the whole split (host clock)."""
    from ctr_recommendation_tpu_torch.data.device_store import device_join
    from ctr_recommendation_tpu_torch.data.wire import build_wire_plan, pack_columns
    from ctr_recommendation_tpu_torch.inference.submission import format_rows
    from ctr_recommendation_tpu_torch.models import trunk
    from ctr_recommendation_tpu_torch.ops.cuda.scoring import score_fwd

    plan = build_wire_plan(pred.fm)
    batch = {e.name: torch.as_tensor(rows[e.name][:B_FULL]).cuda() for e in plan.entries}

    def front():
        feats = device_join(dict(batch), pred._mm_tables, pred._join_plan)
        return trunk.apply(pred.params["trunk"], pred.fm, pred.exp.model, feats,
                           compute_dtype=pred.compute_dtype)

    x = front().to(pred.tower_dtype).contiguous()
    bt = pred.exp.model.bilinear_type
    with torch.inference_mode():
        dev = {
            "whole step": time_ms(torch, lambda: pred._score(batch)),
            "join + trunk": time_ms(torch, front),
            "fused_score kernel": time_ms(
                torch, lambda: score_fwd(x, *pred._score_weights, bilinear_type=bt)),
        }
    log(f"[breakdown] device ms per {B_FULL}-row batch: {dev} on {card}")
    t0 = time.perf_counter()
    for s in range(0, N_ROWS, CHUNK_ROWS):
        chunk = {k: v[s : s + CHUNK_ROWS] for k, v in rows.items()}
        pack_columns(chunk, plan, -(-len(chunk["item_id"]) // B_FULL) * B_FULL)
    t_pack = time.perf_counter() - t0
    t0 = time.perf_counter()
    format_rows(bulk)
    t_fmt = time.perf_counter() - t0
    log(f"[breakdown] host s for {N_ROWS} rows: wire pack {t_pack:.4f}, "
        f"CSV format {t_fmt:.4f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from ctr_recommendation_tpu_torch.ops.cuda import build
    from ctr_recommendation_tpu_torch.ops.cuda.interaction import (
        interaction_fwd,
        interaction_fwd_plain,
    )
    from ctr_recommendation_tpu_torch.ops.cuda.scoring import score_fwd, score_fwd_plain

    # ---- phase 1: card, build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    card = smi.strip()
    t0 = time.perf_counter()
    per = build.build()
    log(f"[build] {time.perf_counter() - t0:.1f} s wall; per source {per}")
    for name, text in build.ptxas_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")

    # ---- phase 2: each kernel against its plain version ----
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = {"interaction_fwd": 0.0, "fused_score": 0.0}
    failures = []
    for btype in ("all", "each"):
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            for b in (B_FULL, B_RAGGED):
                x, sw, w_bi, tower = kernel_inputs(torch, btype, dtype, b, seed=b)
                cases = {
                    "interaction_fwd": (
                        interaction_fwd(x, *sw, w_bi, bilinear_type=btype),
                        interaction_fwd_plain(x, *sw, w_bi, bilinear_type=btype),
                    ),
                    "fused_score": (
                        score_fwd(x, *sw, w_bi, *tower, bilinear_type=btype),
                        score_fwd_plain(x, *sw, w_bi, *tower, bilinear_type=btype),
                    ),
                }
                torch.cuda.synchronize()
                for name, (got, want) in cases.items():
                    err, bad, tol = check_close(name, got, want, dn)
                    worst[name] = max(worst[name], err)
                    ok = bad == 0 and bool(torch.isfinite(got).all())
                    log(f"[compare] {name} {btype} {dn} B={b}: max_abs_err={err:.3e} "
                        f"({tol}) {'ok' if ok else f'FAIL ({bad} elements)'}")
                    if not ok:
                        failures.append((name, btype, dn, b))
    if failures:
        raise SystemExit(f"kernel disagrees with its plain version: {failures}")

    # ---- phase 3: timing at the main path's shapes (bf16, B=8192) ----
    P = F * (F - 1) // 2
    cdim = (F + P) * E
    h1, h2 = HIDDEN
    timing = {}
    for btype in ("all", "each"):
        x, sw, w_bi, tower = kernel_inputs(torch, btype, torch.bfloat16, B_FULL, seed=1)
        # bytes: each input read once, each output written once
        w_bytes = 4 * sum(t.numel() for t in sw) + 2 * w_bi.numel()
        inter_bytes = 2 * x.numel() + w_bytes + 4 * B_FULL * cdim
        inter_ops = 2 * B_FULL * (F - 1) * E * E  # the F-1 projections the pairs use
        tower_w_bytes = sum(t.numel() * t.element_size() for t in tower)
        score_bytes = 2 * x.numel() + w_bytes + tower_w_bytes + 4 * B_FULL
        score_ops = inter_ops + 2 * B_FULL * (cdim * h1 + h1 * h2 + h2)
        for name, kern, plain, nbytes, ops in (
            ("interaction_fwd",
             lambda: interaction_fwd(x, *sw, w_bi, bilinear_type=btype),
             lambda: interaction_fwd_plain(x, *sw, w_bi, bilinear_type=btype),
             inter_bytes, inter_ops),
            ("fused_score",
             lambda: score_fwd(x, *sw, w_bi, *tower, bilinear_type=btype),
             lambda: score_fwd_plain(x, *sw, w_bi, *tower, bilinear_type=btype),
             score_bytes, score_ops),
        ):
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_FLOPS["bfloat16"] * 1e3
            timing[(name, btype)] = t = {
                "ms": time_ms(torch, kern),
                "plain_ms": time_ms(torch, plain),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            }
            log(f"[time] {name} bf16 {btype} B={B_FULL}: {t} "
                f"(bytes {nbytes}, ops {ops}) on {card}")
    c = torch.randn(B_FULL, cdim, device="cuda", dtype=torch.bfloat16)
    mm_ms = time_ms(torch, lambda: torch.matmul(c, tower[0]))
    log(f"[time] yardstick, not the same function: one bf16 torch.matmul "
        f"({B_FULL}x{cdim})x({cdim}x{h1}) {mm_ms:.4f} ms on {card}")
    del c, x, sw, w_bi, tower

    # ---- phase 4: the serving main path ----
    from ctr_recommendation_tpu_torch.config import microlens_experiment
    from ctr_recommendation_tpu_torch.data import ItemStore, TableData
    from ctr_recommendation_tpu_torch.features import build_feature_map
    from ctr_recommendation_tpu_torch.inference import Predictor, run_submission_pipeline
    from ctr_recommendation_tpu_torch.models import build_model

    exp = microlens_experiment(data_root="")
    fm = build_feature_map(exp.dataset)
    _, params, state = build_model(fm, exp.model, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    for st in state["mlp"]["layers"]:  # BatchNorm stats off init: the fold is real
        d = st["bn_mean"].shape[0]
        st["bn_mean"] = torch.from_numpy(rng.normal(0, 0.1, d).astype(np.float32))
        st["bn_var"] = torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32))
    item_ids = np.arange(1, 91718)
    store = ItemStore.from_arrays(
        item_ids, rng.standard_normal((len(item_ids), 128)).astype(np.float32)
    )
    rows = make_rows(N_ROWS, seed=11)
    table = TableData(rows, N_ROWS)
    pred = Predictor(exp, params, state, item_store=store)
    if not pred.use_fused:
        raise SystemExit("the default configuration must take the fused branch")
    n_batches = N_ROWS // B_FULL

    pred.score_table(TableData({k: v[:B_FULL] for k, v in rows.items()}, B_FULL))  # warm-up
    torch.cuda.synchronize()
    score_fwd.launches = interaction_fwd.launches = 0
    t0 = time.perf_counter()
    bulk = pred.score_table(table)
    t_bulk = time.perf_counter() - t0
    bulk_launches = score_fwd.launches
    log(f"[main] score_table: {N_ROWS} rows in {t_bulk:.4f} s = {N_ROWS / t_bulk:.0f} rows/s "
        f"on {card}; fused_score launches {bulk_launches}")
    if bulk_launches != n_batches or interaction_fwd.launches != 0:
        raise SystemExit(f"score_table launched {bulk_launches} scoring kernels, "
                         f"expected {n_batches}")
    if bulk.shape != (N_ROWS,) or not np.isfinite(bulk).all():
        raise SystemExit("score_table output is not finite of shape (N,)")
    if not ((bulk > 0) & (bulk < 1)).all():
        raise SystemExit("score_table probabilities outside (0, 1)")

    with tempfile.TemporaryDirectory() as out_dir:
        chunks = (
            {k: v[s : s + CHUNK_ROWS] for k, v in rows.items()}
            for s in range(0, N_ROWS, CHUNK_ROWS)
        )
        score_fwd.launches = 0
        t0 = time.perf_counter()
        written, csv_path, zip_path = run_submission_pipeline(
            chunks, pred, out_dir, batch_size=B_FULL, chunk_rows=CHUNK_ROWS
        )
        t_pipe = time.perf_counter() - t0
        pipe_launches = score_fwd.launches
        log(f"[main] pipeline: {written} rows in {t_pipe:.4f} s = {written / t_pipe:.0f} rows/s "
            f"to CSV+zip on {card}; fused_score launches {pipe_launches}")
        if pipe_launches != n_batches:
            raise SystemExit(f"pipeline launched {pipe_launches} scoring kernels, "
                             f"expected {n_batches}")
        with open(csv_path) as f:
            lines = f.read().splitlines()
        if lines[0] != "ID,Task2" or len(lines) != N_ROWS + 1 or written != N_ROWS:
            raise SystemExit(f"CSV has {len(lines) - 1} rows, header {lines[0]!r}")
        ids, probs = zip(*(ln.split(",") for ln in lines[1:]))
        if not np.array_equal(np.asarray(ids, np.int64), np.arange(N_ROWS)):
            raise SystemExit("CSV IDs are not 0..N-1 in order")
        csv_probs = np.asarray(probs, np.float64).astype(np.float32)
        if not np.isfinite(csv_probs).all() or not ((csv_probs > 0) & (csv_probs < 1)).all():
            raise SystemExit("CSV probabilities not finite in (0, 1)")
        if not np.array_equal(csv_probs, bulk):
            n_diff = int((csv_probs != bulk).sum())
            raise SystemExit(f"pipeline and score_table disagree on {n_diff} rows")
        import zipfile

        with zipfile.ZipFile(zip_path) as z:
            if z.namelist() != [os.path.basename(csv_path)]:
                raise SystemExit(f"zip holds {z.namelist()}")
        log(f"[main] CSV {N_ROWS} rows, IDs in order, probabilities in (0, 1), "
            f"identical to score_table; zip ok")

    where_the_time_goes(torch, pred, rows, bulk, card)

    cpu_pred = Predictor(exp, params, state, item_store=store, device="cpu")
    head = TableData({k: v[:B_FULL] for k, v in rows.items()}, B_FULL)
    cpu_probs = cpu_pred.score_table(head)
    cpu_err = float(np.abs(cpu_probs - bulk[:B_FULL]).max())
    log(f"[main] first {B_FULL} rows vs the CPU Predictor: max_abs_err={cpu_err:.3e} "
        f"(tolerance {CPU_TOL})")
    if cpu_err > CPU_TOL:
        raise SystemExit("card and CPU Predictor disagree")

    # ---- phase 5: the unfused branch (interaction kernel + tower in torch) ----
    unfused = Predictor(exp, params, state, item_store=store, fold_bn=False)
    n_unfused = 4
    interaction_fwd.launches = score_fwd.launches = 0
    got = np.concatenate([
        unfused({k: v[i * B_FULL : (i + 1) * B_FULL] for k, v in rows.items()}).cpu().numpy()
        for i in range(n_unfused)
    ])
    inter_launches = interaction_fwd.launches
    unfused_err = float(np.abs(got - bulk[: n_unfused * B_FULL]).max())
    log(f"[unfused] {n_unfused} batches: interaction_fwd launches {inter_launches}, "
        f"max_abs_err vs fused {unfused_err:.3e} (tolerance {CPU_TOL})")
    if inter_launches != n_unfused or score_fwd.launches != 0:
        raise SystemExit("the unfused branch did not run the interaction kernel once a batch")
    if unfused_err > CPU_TOL:
        raise SystemExit("unfused and fused branches disagree")

    # ---- phase 6: result ----
    kernels = [
        {"name": "interaction_fwd", "route": "cuda",
         "source": "ctr_recommendation_tpu_torch/csrc/interaction.cu",
         "replaces": "ctr_recommendation_tpu/ops/pallas/interaction.py:56",
         "launches": inter_launches, "max_abs_err": worst["interaction_fwd"],
         **timing[("interaction_fwd", "all")], "library_ms": None},
        {"name": "fused_score", "route": "cuda",
         "source": "ctr_recommendation_tpu_torch/csrc/scoring.cu",
         "replaces": "ctr_recommendation_tpu/ops/pallas/scoring.py:36",
         "launches": pipe_launches, "max_abs_err": worst["fused_score"],
         **timing[("fused_score", "all")], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
