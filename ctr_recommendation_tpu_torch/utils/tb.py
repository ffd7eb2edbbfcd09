"""Optional TensorBoard scalar logging.

The per-epoch ``metrics.csv`` is the source of truth. This adds the
standard TensorBoard event stream on top, via torch's SummaryWriter when
the tensorboard package is importable, and is silently disabled otherwise.
"""

from __future__ import annotations


class ScalarWriter:
    """Best-effort TensorBoard scalar writer; a no-op when tensorboard is
    unavailable or ``logdir`` is falsy."""

    def __init__(self, logdir: str | None):
        self._w = None
        if not logdir:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._w = SummaryWriter(logdir)
        except Exception:
            self._w = None

    @property
    def active(self) -> bool:
        return self._w is not None

    def scalars(self, step: int, values: dict, prefix: str = "") -> None:
        if self._w is None:
            return
        for k, v in values.items():
            try:
                self._w.add_scalar(f"{prefix}{k}", float(v), global_step=step)
            except (TypeError, ValueError):
                continue
        self._w.flush()

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
            self._w = None
