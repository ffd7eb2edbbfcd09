"""One run of one cell: set-up, the measured window, the comparison with the
plain reference, the metrics and the result line."""

from __future__ import annotations

import contextlib
import json
import math
import sys
import time

import torch

from harness import compare, guard, spec, tracing

GIB = float(1 << 30)


class Run:
    """What a per-layer metric's reader reads: the cell, its window's
    statistics (steps or calls, host times, the counted wrappers' launches)
    and, in a traced run, its ``Trace``."""

    def __init__(self, cell, job, stats: dict, trace: tracing.Trace | None, launches_per_call):
        self.cell, self.job, self.stats, self.trace = cell, job, stats, trace
        self.sizes = cell.config["sizes"]
        self.kind = cell.kind
        self.batch = job.bs
        self.launches_per_call = launches_per_call
        self.notes: list[str] = []

    def note(self, msg: str) -> None:
        self.notes.append(msg)


@contextlib.contextmanager
def fp32_reference():
    """Float32 matrix products in full precision (TF32 off) while the
    reference runs; the settings are put back afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def device_info(device: torch.device, chips: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}


def per_layer(cell, run: Run) -> dict:
    out = {}
    for m in cell.per_layer:
        reader = spec.metric_reader(m["name"], cell.bench_dir)
        for attr, key in (("UNIT", "unit"), ("LAYER", "layer"), ("MOVES", "moves")):
            if getattr(reader, attr) != m[key]:
                raise SystemExit(f"metric {m['name']}: its reader's {attr} "
                                 f"{getattr(reader, attr)!r} is not BENCHMARK.json's {m[key]!r}")
        value = reader.read(run)
        if value is None:
            run.note(f"{m['name']}: nothing to read in this run")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell, *, seed: int, seconds: float, trace: bool, device, stages: list,
             shrink: dict | None = None) -> tuple[dict, list[str]]:
    """One run; returns (the result object, the stderr lines of its checks).
    ``stages`` holds (name, host time) pairs of the set-up so far, the
    first the process's start; set-up runs from there to the window."""
    device = torch.device(device)
    stages = list(stages)

    def mark(name):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stages.append((name, time.perf_counter()))

    job = spec.kind_driver(cell.kind, cell.bench_dir).Job(cell, seed, device, shrink)
    try:
        job.make_inputs()
        mark("inputs")
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        job.build()
        mark("build")
        job.warm_up()
        mark("warm-up")
        setup_s = stages[-1][1] - stages[0][1]
        with tracing.profiled(trace) as held:
            with tracing.span(tracing.WINDOW_SPAN):
                stats = job.window(seconds)
        dev_info = device_info(device, cell.chips)
        from harness import program  # the port, already loaded by the job

        run = Run(cell, job, stats, held.trace, program.launches_per_call())
        layer_metrics = per_layer(cell, run) if trace else {}
        job.release()
        with fp32_reference():
            readings = job.readings()
    finally:
        job.close()
    checked = compare.checks(readings, cell.limits)
    correct = compare.passed(checked) and stats["failed"] == 0
    if trace:
        metrics = layer_metrics
        dev_info["busy_s"] = held.trace.busy_s
        dev_info["window_s"] = held.trace.window_s
    else:
        metrics = {}
        e2e = dict(stats["end_to_end"])
        e2e["peak_mem_gib"] = dev_info["memory_peak_bytes"] / GIB
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(stats["attempted"]),
              "failed": int(stats["failed"]), "metrics": metrics, "device": dev_info}
    if trace:
        result["breakdown"] = {"device_ops": held.trace.device_ops(),
                               "idle_gaps": held.trace.idle_gaps()}
    result["checks"] = checked
    lines = list(run.notes)
    lines.append("set-up s: " + ", ".join(
        f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(stages, stages[1:]))
        + f"; {setup_s:.3f} in all")
    if stats.get("host_s"):
        q = sorted(stats["host_s"])
        lines.append(f"host ms a {'step' if cell.kind == 'train' else 'call'}: quartiles "
                     f"{1e3 * q[len(q) // 4]:.3f} {1e3 * q[len(q) // 2]:.3f} "
                     f"{1e3 * q[3 * len(q) // 4]:.3f}, {len(q)} in {stats['wall_s']:.3f} s")
    worst = readings.get("_worst")
    if worst:
        lines.append(f"worst: {json.dumps(worst)}")
    lines += [f"check {k}: {c['value']!r} (limit {c['limit']!r}) "
              f"{'ok' if math.isfinite(c['value']) and c['value'] <= c['limit'] else 'FAIL'}"
              for k, c in checked.items()]
    if stats["failed"]:
        lines.append(f"check failed: {stats['failed']} of {stats['attempted']} (limit 0) FAIL")
    return result, lines


def emit(result: dict, lines: list[str]) -> int:
    """Print the check lines last on stderr and the result as the last line
    of stdout, unless the process holds a forbidden module: then no result
    and a non-zero exit."""
    found = guard.forbidden_modules()
    if found:
        print(f"the benchmark's process holds modules of JAX or the JAX package: {found}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result)), flush=True)
    return 0


def _finite(x):
    """The result with each non-finite number as null (strict JSON)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x
