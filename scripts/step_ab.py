"""One mm_fibinet training step of two trees of the port on one card, in turns.

    python3 scripts/step_ab.py PARENT_DIR

PARENT_DIR is an unpacked tree of another commit (``git archive <commit> |
tar -x -C PARENT_DIR`` into a directory ``.gitignore`` lists); the other tree
is this checkout. Runs parent, change, change, parent, each in a process of
its own (its own kernel builds), and prints one JSON line a run: the step's
host wall (median and quartiles of 40 steps, each ending in a synchronize),
its device-busy ms and kernels a step (``torch.profiler`` over 5 more), and
the device µs a step of the table gradient's kernels, of ``torch.sort`` and
of concatenations. The step is the full ``microlens_experiment()`` default
(batch 4096, E=128, bf16) on seeded synthetic rows. Needs a CUDA card;
imports nothing of JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys

CHILD = r'''
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
from ctr_recommendation_tpu_torch.config import microlens_experiment
from ctr_recommendation_tpu_torch.data import synthetic_splits
from ctr_recommendation_tpu_torch.training import Trainer

train, _, store = synthetic_splits(4 * 4096, 1024, seed=0)
exp = microlens_experiment(data_root="", checkpoint_dir=sys.argv[3])
tr = Trainer(exp, steps_per_epoch=64, item_store=store, log_fn=lambda s: None)
batch = {k: torch.as_tensor(v[:4096]).cuda() for k, v in train.columns.items()}

def step():
    with torch.enable_grad():
        loss, aux = tr.forward_loss(batch)
        grads = tr.gradients(loss, aux)
    tr.apply_gradients(grads, aux)

for _ in range(5):
    step()
torch.cuda.synchronize()
walls = []
for _ in range(40):
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    walls.append(1e3 * (time.perf_counter() - t0))
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(5):
        step()
    torch.cuda.synchronize()
ev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
us = lambda keep: sum(e.self_device_time_total for e in ev if keep(e.key)) / 5  # noqa: E731
grad = ("sum", "key", "digit", "row", "chunk", "slice")
print(json.dumps({
    "tree": sys.argv[2], "wall_ms_median": float(np.median(walls)),
    "wall_ms_quartiles": [float(np.percentile(walls, 25)), float(np.percentile(walls, 75))],
    "busy_ms": us(lambda k: True) / 1e3, "kernels": sum(e.count for e in ev) // 5,
    "cat_us": us(lambda k: "cat" in k.lower()), "sort_us": us(lambda k: "sort" in k.lower()),
    "table_grad_us": {e.key.split("(")[0][-28:]: round(e.self_device_time_total / 5, 1)
                      for e in ev if "ctr::" in e.key and any(g in e.key for g in grad)}}))
'''


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent, here = os.path.abspath(sys.argv[1]), os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    rc = 0
    for i, tag in enumerate(["parent", "change", "change", "parent"]):
        root = parent if tag == "parent" else here
        ckpt = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"step_ab_{os.getpid()}_{i}")
        out = subprocess.run([sys.executable, "-c", CHILD, root, tag, ckpt], capture_output=True,
                             text=True, cwd=root)
        if out.returncode:
            print(f"{tag}: exit {out.returncode}\n{out.stderr[-3000:]}", flush=True)
            rc = 1
        else:
            print(out.stdout.strip().splitlines()[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
