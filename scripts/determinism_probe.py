"""Whether a training step of the PyTorch port repeats bit for bit on one card,
in one short call.

    python3 scripts/determinism_probe.py

Builds the kernels (``ops/cuda/build.py``), holds ``table_grad`` against its
fp64 plain version with 10 repeats a shape and times it beside the library
call (``chip_smoke.py``'s ``table_grad_against_plain`` and
``table_grad_timing``), then, at the full ``microlens_experiment()`` width on
4096 rows of the synthetic splits, for mm_fibinet, sasrec_fibinet, the nine
zoo models and mm_fibinet with a sparse table optimizer under each forced
strategy: one train step, then ``chip_smoke.repeat_probe`` (the next step's
loss and gradients on the same batch twice; the leaves that differ logged,
``[probe ...]`` lines) and the same forward and backward again under
``torch.use_deterministic_algorithms(True, warn_only=True)``, PyTorch's
warnings about operations it knows to be nondeterministic logged
(``[det ...]`` lines). Exits 1 when a check fails or a leaf differs. Needs a
CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
import warnings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SPARSE = (("rowwise_adagrad", "masked_dense"), ("adam", "gathered"))


def main() -> int:
    import torch

    import chip_smoke as cs
    from ctr_recommendation_tpu_torch.config import microlens_experiment
    from ctr_recommendation_tpu_torch.data import synthetic_splits
    from ctr_recommendation_tpu_torch.ops.cuda import build
    from ctr_recommendation_tpu_torch.training import Trainer, sparse

    if not torch.cuda.is_available():
        print("determinism_probe: CUDA is not available", file=sys.stderr)
        return 1
    t0 = time.time()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print("[build]", build.build(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, failures = cs.table_grad_against_plain(torch)
    cs.table_grad_timing(torch, card)

    train, _, store = synthetic_splits(2 * cs.B_TRAIN, 1024, seed=0)
    batch = {k: torch.as_tensor(v[: cs.B_TRAIN]).cuda() for k, v in train.columns.items()}
    cases = [(m, {}, None) for m in ("mm_fibinet", "sasrec_fibinet", *cs.ZOO)]
    cases += [("mm_fibinet", {"table_optimizer": kind}, strategy) for kind, strategy in SPARSE]
    default_ratio = sparse.GATHERED_MIN_VOCAB_RATIO
    apart = {}
    with tempfile.TemporaryDirectory() as root:
        for i, (model, kw, strategy) in enumerate(cases):
            sparse.GATHERED_MIN_VOCAB_RATIO = cs.FORCE_STRATEGY.get(strategy, default_ratio)
            tag = " ".join([model, *kw.values(), *([strategy] if strategy else [])])
            exp = microlens_experiment(data_root="", model=model,
                                       checkpoint_dir=os.path.join(root, f"probe_{i}"), **kw)
            tr = Trainer(exp, steps_per_epoch=4, item_store=store, log_fn=lambda s: None)
            tr.train_step(batch)
            apart[tag] = cs.repeat_probe(torch, tr, batch, tag, card, hard=False)
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    with torch.enable_grad():
                        loss, aux = tr.forward_loss(batch)
                        tr.gradients(loss, aux)
                    torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
            print(f"[det {tag}] warnings: {sorted({str(w.message)[:160] for w in caught})}",
                  flush=True)
            del tr
    sparse.GATHERED_MIN_VOCAB_RATIO = default_ratio
    moved = {k: v for k, v in apart.items() if v}
    print(f"[summary] table_grad failures {failures}; leaves apart {moved or 'none'}; "
          f"{time.time() - t0:.1f} s", flush=True)
    return 1 if failures or moved else 0


if __name__ == "__main__":
    sys.exit(main())
