"""Profiling: a ``torch.profiler`` trace of a block (``trace``), and the
program's stage spans (``span``, ``stage_boundary``), kept by one
per-process ``Recorder`` (``RECORDER``) while a profiler runs.

Off (no ``torch.profiler`` running, the common case) a span costs one read
of the profiler's module flag and is a shared no-op context, and a stage
boundary returns its tensor itself: no hook, no event. On, a span is a
``record_function`` range, so it lies in the profiler's trace on the
kernels' clock, and a record in ``RECORDER``: its name, its parent's, the
host's ``perf_counter`` at its ends and, once the process uses CUDA, a pair
of timing events on the current stream. ``RECORDER.totals()`` reads them
out once, at the end.

Backward stages have no call to wrap: ``stage_boundary(t, name)`` puts a
gradient hook on ``t`` that closes the running backward stage and opens
``name`` when autograd reaches ``t``. A stage still open when its enclosing
span closes (the last one of a backward) closes with it."""

from __future__ import annotations

import contextlib
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler
import torch.distributed as dist


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block into
    ``log_dir/rank<R>.pt.trace.json`` (Chrome trace JSON, which Perfetto and
    TensorBoard's profiler plugin read; R is the process group's rank, 0
    without one): host activity, the program's stage spans, and the
    device's once this process uses CUDA. On exit the device is
    synchronized first, so the trace holds the block's kernels to their
    end."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    rank = dist.get_rank() if dist.is_initialized() else 0
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"rank{rank}.pt.trace.json"))


class _Record:
    """One span as the recorder keeps it. ``repeat``: opened inside a span
    of its own name, so it adds nothing to that name's totals."""

    __slots__ = ("name", "parent", "repeat", "stage", "range", "ev0", "ev1", "host0", "host1",
                 "bytes", "device_s")

    def __init__(self, name: str, parent: str | None, repeat: bool, stage: bool):
        self.name, self.parent, self.repeat, self.stage = name, parent, repeat, stage
        self.ev0 = self.ev1 = self.host1 = self.device_s = None
        self.bytes = 0


class Recorder:
    """The spans of this process since the last ``reset()``, in the order
    they opened. One stack of open spans serves every thread: a backward
    runs on autograd's device thread while the thread that called it waits
    inside its span, so the spans never interleave."""

    def __init__(self):
        self.records: list[_Record] = []
        self._open: list[_Record] = []

    def open(self, name: str, *, stage: bool = False) -> _Record:
        rec = _Record(name, self._open[-1].name if self._open else None,
                      any(r.name == name for r in self._open), stage)
        rec.range = _autograd_profiler.record_function(name)
        rec.range.__enter__()
        if torch.cuda.is_initialized():
            rec.ev0 = torch.cuda.Event(enable_timing=True)
            rec.ev0.record()
        rec.host0 = time.perf_counter()
        self._open.append(rec)
        self.records.append(rec)
        return rec

    def close(self, rec: _Record) -> None:
        """Close ``rec`` and every span opened inside it that is still open."""
        while self._open:
            top = self._open.pop()
            top.host1 = time.perf_counter()
            if top.ev0 is not None:
                top.ev1 = torch.cuda.Event(enable_timing=True)
                top.ev1.record()
            top.range.__exit__(None, None, None)
            top.range = None
            if top is rec:
                return

    def stage(self, name: str) -> None:
        """Close the running backward stage, if one is innermost, and open
        ``name`` as the next."""
        if self._open and self._open[-1].stage:
            self.close(self._open[-1])
        self.open(name, stage=True)

    def totals(self) -> dict[str, dict]:
        """Per span name, over its closed spans (a span inside one of its own
        name left out): ``calls``, ``host_s`` (the host's time between the
        span's ends), ``device_s`` (the time between its two events on the
        device's stream, so the device time of the work the span enqueued,
        with the stream's idle gaps in between; the host time where the
        process does not use CUDA, as CPU work is synchronous) and ``bytes``
        (what the span counted with ``add_bytes``). Waits for the device
        where an event is pending."""
        out: dict[str, dict] = {}
        for r in self.records:
            if r.host1 is None:
                continue
            if r.device_s is None:
                if r.ev0 is None:
                    r.device_s = r.host1 - r.host0
                else:
                    r.ev1.synchronize()
                    r.device_s = r.ev0.elapsed_time(r.ev1) * 1e-3
                    r.ev0 = r.ev1 = None
            if r.repeat:
                continue
            t = out.setdefault(r.name, {"calls": 0, "host_s": 0.0, "device_s": 0.0, "bytes": 0})
            t["calls"] += 1
            t["host_s"] += r.host1 - r.host0
            t["device_s"] += r.device_s
            t["bytes"] += r.bytes
        return out

    def reset(self) -> None:
        """Forget every closed span (open ones are kept to be closed)."""
        self.records = list(self._open)


RECORDER = Recorder()


class _Span:
    __slots__ = ("name", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rec = RECORDER.open(self.name)
        return self

    def __exit__(self, *exc):
        RECORDER.close(self.rec)

    def add_bytes(self, n: int) -> None:
        """Count ``n`` bytes moved inside this span (``totals()['bytes']``)."""
        self.rec.bytes += int(n)


class _Off:
    """The span of a process no profiler traces: it does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def add_bytes(self, n: int) -> None:
        pass


_OFF = _Off()


def span(name: str):
    """A context over one stage of the program, named ``name`` in the
    profiler's trace and in ``RECORDER``, while a ``torch.profiler`` runs;
    else a shared no-op. Either way ``with span(n) as s: s.add_bytes(k)``."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def stage_boundary(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t`` itself. While a profiler runs and ``t`` takes a gradient, the
    backward stage ``name`` opens (and the one before it closes) when
    autograd reaches ``t``: when ``t``'s gradient is whole, so everything
    that consumed ``t`` has been differentiated."""
    if _autograd_profiler._is_profiler_enabled and t.requires_grad:
        t.register_hook(lambda g: RECORDER.stage(name))
    return t
