"""optim.foreach_ms_per_step: the device time of the ``multi_tensor_apply``
kernels a step: the foreach Adam and the clip's norms and scale."""

UNIT = "ms/step"
LAYER = "optimizer (training/optim.py)"
MOVES = "train_examples_per_s"


def read(run):
    if run.kind != "train" or run.trace is None or not run.stats["steps"]:
        return None
    ks = run.trace.kernels(r"multi_tensor_apply_kernel")
    if not ks:
        run.note("optim.foreach_ms_per_step: no multi_tensor_apply kernel in the trace")
        return None
    return 1e3 * run.trace.seconds(ks) / run.stats["steps"]
