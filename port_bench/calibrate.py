"""Readings that a cell's limits are set from (``port_bench/limits/<cell>.json``;
PERF.md keeps each limit with its readings).

    python3 port_bench/calibrate.py --workload <cell> --seeds 11,12,... [--controls 3]

For each seed, in one process: the cell's set-up and warm-up as a run
makes them (a training cell's compared steps; a scoring cell's calls over a
short window at the cell's own load), then the program's numbers against
the float32 reference. For the first ``--controls`` seeds also the
control's (the reference in the precision below the configuration's: bf16
-> scaled fp8) and, for training cells, the planted fault that leaves half
of each batch out of the loss (the reference with the fault, put in the
program's place), and, as a witness, the reference rounded to bf16 where
the configuration computes in bf16. One JSON line a seed on stdout. Needs a CUDA device,
except with ``--device cpu`` (a rehearsal at the sizes ``--shrink`` gives).
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.getcwd()
sys.path[:0] = [HERE, ROOT]

SCORE_WINDOW_S = 1.0


def numbers(readings: dict) -> dict:
    return {k: v for k, v in readings.items() if not k.startswith("_")}


def calibrate(cell, seed: int, device, *, control: bool, shrink: dict | None = None) -> dict:
    import torch

    from harness import runner, spec
    from harness.compare import prob_gap, train_readings
    from reference.precision import bf16, fp8

    job = spec.kind_driver(cell.kind, cell.bench_dir).Job(cell, seed, device, shrink)
    out = {"seed": seed}
    try:
        job.make_inputs()
        job.build()
        job.warm_up()
        if cell.kind == "score":
            job.window(SCORE_WINDOW_S)
        job.release()
        with runner.fp32_reference():
            ref = job.reference()
            kw = {"leaves": True} if cell.kind == "train" else {}
            got = job.readings(ref, **kw)
            out["program"], out["worst"] = numbers(got), got.get("_worst")
            if control:
                if cell.kind == "train":
                    ctrl = train_readings(job.reference(rnd=fp8), ref, leaves=True)
                    out["control"], out["control_worst"] = numbers(ctrl), ctrl["_worst"]
                    half = job.reference(loss_rows=job.bs // 2)
                    out["half_batch"] = numbers(train_readings(half, ref))
                    out["bf16_reference"] = numbers(train_readings(job.reference(rnd=bf16), ref))
                else:
                    out["control"] = {"prob_gap": prob_gap(job.reference(rnd=fp8), ref)}
                    out["bf16_reference"] = {"prob_gap": prob_gap(job.reference(rnd=bf16), ref)}
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    finally:
        job.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--shrink", default="{}", help="JSON of traffic keys to override")
    args = ap.parse_args(argv)

    from harness import program, spec

    cell = spec.cell(ROOT, args.workload)
    if args.device.startswith("cuda"):
        program.build_kernels()
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = calibrate(cell, seed, args.device, control=i < args.controls,
                        shrink=json.loads(args.shrink))
        res["seconds"] = time.perf_counter() - t0
        print(json.dumps({"workload": args.workload, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
