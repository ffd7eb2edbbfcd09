"""trainer.unspanned_ms_per_step: the device time a training step spends
outside every stage the other span metrics read: ``train.step`` less
``train.join``, ``trunk``, ``trunk.bwd``, ``interaction``,
``interaction.bwd``, ``tower``, ``train.loss``, ``tower.bwd`` and
``train.optimizer`` (a stage a model does not mark counts 0). What is left
is the step's own glue: the dropout seed, the loss's backward, the step's
bookkeeping. Read from the program's own spans (``Trainer.spans``)."""

UNIT = "ms/step"
LAYER = "Trainer (training/loop.py)"
MOVES = "train_examples_per_s"
STAGES = ("train.join", "trunk", "trunk.bwd", "interaction", "interaction.bwd", "tower",
          "train.loss", "tower.bwd", "train.optimizer")


def read(run):
    tot, steps = _totals(run)
    if not steps:
        return None
    step_s = tot["train.step"]["device_s"]
    staged = sum(tot[s]["device_s"] for s in STAGES if s in tot)
    run.note(f"trainer.unspanned_ms_per_step: train.step {step_s:.6f} s of device time over "
             f"{steps} steps in a window of {run.trace.window_s:.6f} s; the stages "
             f"{staged:.6f} s")
    return 1e3 * (step_s - staged) / steps


def _totals(run):
    """The program's span totals over the window (``Trainer.spans``), and
    its steps; None where the run is untraced or the program has no spans."""
    spans = getattr(getattr(run.job, "trainer", None), "spans", None)
    if run.kind != "train" or run.trace is None or spans is None:
        return None, 0
    tot = spans.totals()
    return tot, tot.get("train.step", {}).get("calls", 0)
