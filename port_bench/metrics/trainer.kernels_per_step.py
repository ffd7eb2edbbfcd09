"""trainer.kernels_per_step: the device kernels in the traced window over
its training steps (an exact count of the window's work)."""

UNIT = "kernels/step"
LAYER = "Trainer (training/loop.py)"
MOVES = "train_examples_per_s"


def read(run):
    if run.kind != "train" or run.trace is None or not run.stats["steps"]:
        return None
    return len(run.trace.kernels()) / run.stats["steps"]
