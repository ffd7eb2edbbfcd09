"""trainer.host_ms_per_step: the host's time in ``Trainer.train_step`` a
step (the benchmark's clock around each call). Where the launch queue is
full, a call waits for it, and that wait is in this number."""

UNIT = "ms/step"
LAYER = "Trainer (training/loop.py)"
MOVES = "train_examples_per_s"


def read(run):
    host = run.stats.get("host_s")
    if run.kind != "train" or not host:
        return None
    return 1e3 * sum(host) / len(host)
