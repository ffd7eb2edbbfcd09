"""Traffic kind ``score``: ``Predictor.score_table`` over a test split held
on the host, called again and again, as offline scoring of a submission
calls it: each call uploads the split's columns (padded to whole batches),
scores it batch by batch on the device and returns the probabilities to
the host.

Set-up makes the split, the item vectors and the weights (with BatchNorm
statistics and affine parameters away from their initial values, so that
``Predictor`` folds real work) from the seed, builds the Predictor and
scores the split once (the warm-up). The window keeps the outputs of a few
calls drawn from the seed (reservoir sampling); after it the plain
reference scores the whole split, in blocks of the traffic's batch, and
every kept output is compared in full.

Traffic file keys: ``kind``, ``batch_size``, ``test_rows``, ``hist_len``
([shortest, longest] history).
"""

from __future__ import annotations

import gc
import random
import time

import torch

from harness import data, program, seeds, tracing, weights
from harness.compare import prob_gap
from reference import model as ref_model

KEPT = 3  # calls of the window whose outputs are compared


class Job:
    def __init__(self, cell, seed: int, device, shrink: dict | None = None):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        t = dict(cell.traffic)
        t.update(shrink or {})
        self.traffic = t
        self.sizes = cell.config["sizes"]
        self.bs = int(t["batch_size"])
        self.n = int(t["test_rows"])

    def make_inputs(self) -> None:
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(seeds.sub_seed(self.seed, "data"))
        self.world = data.World(gen, self.sizes, dev)
        cols = data.rows(gen, self.world, self.n, self.sizes, self.traffic["hist_len"],
                         label=False, device=dev)
        self.host_cols = {k: v.cpu().numpy() for k, v in cols.items()}
        del cols
        wgen = torch.Generator(device=dev).manual_seed(seeds.sub_seed(self.seed, "weights"))
        self.params, self.state = weights.make(self.sizes, wgen, dev, served=True)
        self.pick = random.Random(seeds.sub_seed(self.seed, "kept calls"))

    def build(self) -> None:
        self.exp = program.experiment(self.cell.config, batch_size=self.bs)
        self.predictor = program.predictor(
            self.exp, store=program.item_store(self.world.item_emb), params=self.params,
            state=self.state, device=self.device)
        self.split = program.table(self.host_cols, self.n)

    def warm_up(self) -> None:
        self.predictor.score_table(self.split, self.bs)

    def window(self, seconds: float) -> dict:
        pred, split = self.predictor, self.split
        kept: list = []
        rows = calls = failed = 0
        call_s = []
        c0 = program.counters()
        t0 = time.perf_counter()
        while True:
            h0 = time.perf_counter()
            with tracing.span("port_bench.score_table"):
                out = pred.score_table(split, self.bs)
            call_s.append(time.perf_counter() - h0)
            calls += 1
            if out.shape != (self.n,):
                failed += 1
            else:
                rows += out.shape[0]
            # reservoir sampling of KEPT calls, drawn from the seed
            if len(kept) < KEPT:
                kept.append((calls, out))
            else:
                j = self.pick.randrange(calls)
                if j < KEPT:
                    kept[j] = (calls, out)
            if time.perf_counter() - t0 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        c1 = program.counters()
        self.kept = kept
        return {"wall_s": wall, "steps": calls, "attempted": calls, "failed": failed,
                "batches": calls * -(-self.n // self.bs), "rows": rows, "host_s": call_s,
                "counters": {k: c1[k] - c0[k] for k in c0},
                "end_to_end": {"score_rows_per_s": rows / wall}}

    def release(self) -> None:
        self.predictor = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, *, rnd=None) -> torch.Tensor:
        kw = {} if rnd is None else {"rnd": rnd}
        cols = {k: torch.from_numpy(v).to(self.device) for k, v in self.host_cols.items()}
        return ref_model.probabilities(self.params, self.state, cols, self.world.item_emb,
                                       self.sizes, rows=self.bs, **kw)

    def readings(self, ref: torch.Tensor | None = None) -> dict:
        ref = self.reference() if ref is None else ref
        gaps = [prob_gap(torch.as_tensor(out).to(ref.device), ref) for _, out in self.kept]
        return {"prob_gap": max(gaps), "_worst": {"calls": [c for c, _ in self.kept]}}

    def close(self) -> None:
        pass
