"""tower.train_ms_per_step: the device time a training step spends in the DNN
tower and the loss: the tower's forward (span ``tower``), the BCE
(``train.loss``) and the tower's backward (the backward stage
``tower.bwd``). Read from the program's own spans (``Trainer.spans``: a CUDA
event at each end of each span), summed over the window and divided by its
``train.step`` spans."""

UNIT = "ms/step"
LAYER = "tower (ops/mlp.py)"
MOVES = "train_examples_per_s"
STAGES = ("tower", "train.loss", "tower.bwd")


def read(run):
    tot, steps = _totals(run)
    if not steps:
        return None
    missing = [s for s in STAGES if s not in tot]
    if missing:
        run.note(f"tower.train_ms_per_step: no span {missing} in the window")
        return None
    return 1e3 * sum(tot[s]["device_s"] for s in STAGES) / steps


def _totals(run):
    """The program's span totals over the window (``Trainer.spans``), and
    its steps; None where the run is untraced or the program has no spans."""
    spans = getattr(getattr(run.job, "trainer", None), "spans", None)
    if run.kind != "train" or run.trace is None or spans is None:
        return None, 0
    tot = spans.totals()
    return tot, tot.get("train.step", {}).get("calls", 0)
