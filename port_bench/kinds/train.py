"""Traffic kind ``train``: ``Trainer.train_step`` over a training split
resident on the device, as ``fit_on_device`` drives it: each epoch a
permutation drawn on the device, cut into batches of the traffic's size;
no eval in the window.

Set-up makes the split, the item vectors and the weights from the seed,
builds one Trainer and runs the first ``COMPARED`` steps through the
window's own call and feed (its warm-up), keeping each step's loss, the
first step's gradient as the optimizer took it and each leaf's change over
those steps; the window goes on with the same Trainer from the next batch.
After the window the plain reference repeats the compared steps from the
same weights and rows.

Traffic file keys: ``kind``, ``batch_size``, ``train_rows``, ``hist_len``
([shortest, longest] history), ``total_steps`` (the learning-rate
schedule's length, past any window).
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time

import torch

from harness import data, program, seeds, tracing, weights
from harness.compare import train_readings
from reference import train as ref_train

COMPARED = 3  # steps the reference follows


class Job:
    def __init__(self, cell, seed: int, device, shrink: dict | None = None):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        t = dict(cell.traffic)
        t.update(shrink or {})
        self.traffic = t
        self.sizes = cell.config["sizes"]
        self.bs = int(t["batch_size"])
        self.n = int(t["train_rows"])
        self.steps_per_epoch = self.n // self.bs
        if self.steps_per_epoch <= COMPARED:
            raise ValueError(f"{self.n} rows make {self.steps_per_epoch} batches of {self.bs}")
        self.ckpt = tempfile.mkdtemp(prefix="port_bench_ckpt_")
        self.train_seed = seeds.sub_seed(seed, "dropout") % (1 << 31)

    # ------------------------------------------------------------ set-up
    def make_inputs(self) -> None:
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(seeds.sub_seed(self.seed, "data"))
        self.world = data.World(gen, self.sizes, dev)
        self.split = data.rows(gen, self.world, self.n, self.sizes, self.traffic["hist_len"],
                               label=True, device=dev)
        wgen = torch.Generator(device=dev).manual_seed(seeds.sub_seed(self.seed, "weights"))
        self.params0, self.state0 = weights.make(self.sizes, wgen, dev)
        self.perm_gen = torch.Generator(device=dev).manual_seed(seeds.sub_seed(self.seed, "perm"))

    def build(self) -> None:
        t = self.traffic
        self.exp = program.experiment(self.cell.config, batch_size=self.bs,
                                      train_seed=self.train_seed, checkpoint_dir=self.ckpt)
        self.trainer = program.trainer(
            self.exp, total_steps=int(t["total_steps"]), store=program.item_store(
                self.world.item_emb), params=self.params0, state=self.state0, device=self.device)

    def _perm(self) -> torch.Tensor:
        return torch.randperm(self.n, generator=self.perm_gen, device=self.device)

    def _batch(self, i: int) -> dict:
        idx = self.perm[i * self.bs:(i + 1) * self.bs]
        return {k: v[idx] for k, v in self.split.items()}

    def warm_up(self) -> None:
        """The compared steps: the window's call on the window's feed."""
        tr = self.trainer
        self.perm, self.pos = self._perm(), 0
        self.compared_rows = [self.perm[i * self.bs:(i + 1) * self.bs].clone()
                              for i in range(COMPARED)]
        losses = []
        p0 = {k: v.detach().clone() for k, v in program.params(tr).items()}
        for i in range(COMPARED):
            losses.append(tr.train_step(self._batch(i)))
            if i == 0:
                self.prog_grad1 = {k: g.detach().clone()
                                   for k, g in program.first_gradients(tr).items()}
        self.pos = COMPARED
        now = program.params(tr)
        self.prog_delta = {k: now[k].detach() - p0[k] for k in now}
        self.prog_losses = [float(x) for x in losses]
        del p0

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> dict:
        tr, dev = self.trainer, self.device
        losses, host = [], []
        c0 = program.counters()
        t0 = time.perf_counter()
        while True:
            if self.pos == self.steps_per_epoch:
                with tracing.span("port_bench.permutation"):
                    self.perm, self.pos = self._perm(), 0
            h0 = time.perf_counter()
            with tracing.span("port_bench.train_step"):
                losses.append(tr.train_step(self._batch(self.pos)))
            h1 = time.perf_counter()
            host.append(h1 - h0)
            self.pos += 1
            if h1 - t0 >= seconds:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        c1 = program.counters()
        steps = len(losses)
        finite = torch.isfinite(torch.stack(losses)).tolist()
        return {"wall_s": wall, "steps": steps, "attempted": steps,
                "failed": finite.count(False), "host_s": host,
                "counters": {k: c1[k] - c0[k] for k in c0},
                "end_to_end": {"train_examples_per_s": steps * self.bs / wall}}

    def release(self) -> None:
        self.trainer = None
        self.perm = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        shutil.rmtree(self.ckpt, ignore_errors=True)

    # ------------------------------------------------------------ reference
    def reference(self, *, rnd=None, loss_rows: int | None = None) -> dict:
        batches = [{k: v[rows] for k, v in self.split.items()} for rows in self.compared_rows]
        train = dict(self.cell.config["sizes"])
        train["seed"] = self.train_seed
        kw = {} if rnd is None else {"rnd": rnd}
        return ref_train.steps(self.params0, self.state0, batches, self.world.item_emb,
                               self.sizes, train, total_steps=int(self.traffic["total_steps"]),
                               loss_rows=loss_rows, **kw)

    def readings(self, ref: dict | None = None, **kw) -> dict:
        ref = self.reference() if ref is None else ref
        prog = {"losses": self.prog_losses, "grad1": self.prog_grad1, "delta": self.prog_delta}
        return train_readings(prog, ref, **kw)

    def close(self) -> None:
        shutil.rmtree(self.ckpt, ignore_errors=True)

