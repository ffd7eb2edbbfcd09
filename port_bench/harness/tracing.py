"""The traced run: ``torch.profiler`` over the measured window, read from
the profiler's own event list (no trace file is written).

``Trace`` holds the window (the harness's ``port_bench.window`` span), the
device operations inside it (kernels, copies and sets, as
chip_smoke.py's ``device_intervals``), the host's operations and the
harness's own spans; ``merged`` is chip_smoke.py's."""

from __future__ import annotations

import contextlib
import re

import torch

WINDOW_SPAN = "port_bench.window"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITIES = ("cpu_op", "user_annotation")


def merged(spans) -> list[tuple]:
    """The union of (start, end) spans, as sorted disjoint spans."""
    out: list[list] = []
    for a, z in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], z)
        else:
            out.append([a, z])
    return [tuple(x) for x in out]


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters: ``void ctr::mma::tile_product<...>(...)`` ->
    ``ctr::mma::tile_product``."""
    n = name.strip()
    if n.startswith("void "):
        n = n[5:]
    n = re.split(r"[<(]", n, maxsplit=1)[0].strip()
    return n or name[:80]


class Trace:
    """What one profiled window holds, times in seconds from the window's start."""

    def __init__(self, events):
        window = sorted((e for e in events if e["name"] == WINDOW_SPAN
                         and not e["kind"].startswith("gpu")), key=lambda e: e["start"] - e["end"])
        if not window:
            kinds = sorted({(e["kind"], e["name"]) for e in events
                            if e["name"].startswith("port_bench")})
            raise RuntimeError(f"no {WINDOW_SPAN} span on the host in the trace; the harness's "
                               f"events there: {kinds}; {len(events)} events")
        w0, w1 = window[0]["start"], window[0]["end"]
        self.window_s = (w1 - w0) * 1e-9

        def rel(e):
            return {**e, "start": (max(e["start"], w0) - w0) * 1e-9,
                    "end": (min(e["end"], w1) - w0) * 1e-9}

        inside = [e for e in events if e["end"] > w0 and e["start"] < w1]
        self.device = [rel(e) for e in inside if e["kind"] in DEVICE_ACTIVITIES]
        self.host = sorted((rel(e) for e in inside if e["kind"] in HOST_ACTIVITIES
                            and e["name"] != WINDOW_SPAN), key=lambda e: e["start"])
        self.busy = merged((e["start"], e["end"]) for e in self.device)
        self.busy_s = sum(z - a for a, z in self.busy)

    def kernels(self, pattern: str | None = None) -> list[dict]:
        """The window's kernels (not copies or sets), those whose name
        matches ``pattern`` (a regular expression) when given."""
        ks = [e for e in self.device if e["kind"] == "kernel"]
        if pattern is not None:
            rx = re.compile(pattern)
            ks = [e for e in ks if rx.search(e["name"])]
        return ks

    @staticmethod
    def seconds(events) -> float:
        return sum(e["end"] - e["start"] for e in events)

    def device_ops(self, top: int = 10) -> list[list]:
        """[short name, seconds] of the device operations that took the most
        time in the window."""
        by: dict[str, float] = {}
        for e in self.device:
            k = short_name(e["name"])
            by[k] = by.get(k, 0.0) + (e["end"] - e["start"])
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """[what the host was doing, seconds] of the device's idle time in
        the window, summed by the host's innermost operation at each gap's
        start (under the harness's own span there), the largest first."""
        gaps, last = [], 0.0
        for a, z in self.busy:
            if a > last:
                gaps.append((last, a))
            last = max(last, z)
        if self.window_s > last:
            gaps.append((last, self.window_s))
        ops = _Innermost(e for e in self.host if e["kind"] == "cpu_op")
        spans = _Innermost(e for e in self.host if e["kind"] == "user_annotation")
        by: dict[str, float] = {}
        for a, z in gaps:
            op, span = ops.at(a) or "(no host operation)", spans.at(a)
            key = f"{span}: {op}" if span else op
            by[key] = by.get(key, 0.0) + (z - a)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


class _Innermost:
    """The latest-started event still open at a time, for times asked in
    increasing order (a sweep: events sorted by start, ended ones dropped
    from the top of the open list)."""

    def __init__(self, events):
        self.events = sorted(events, key=lambda e: e["start"])
        self.next = 0
        self.open: list[dict] = []

    def at(self, t: float) -> str | None:
        while self.next < len(self.events) and self.events[self.next]["start"] <= t:
            self.open.append(self.events[self.next])
            self.next += 1
        while self.open and self.open[-1]["end"] <= t:
            self.open.pop()
        return self.open[-1]["name"] if self.open else None


def _kind(e) -> str:
    """An event's activity type ("kernel", "gpu_memcpy", "cpu_op",
    "user_annotation", ...), from the event itself where this PyTorch says
    it, else from its device and name."""
    if hasattr(e, "activity_type"):
        kind = str(e.activity_type()).lower()
        return kind.rsplit(".", 1)[-1]
    on_device = "CUDA" in str(e.device_type())
    name = e.name()
    user = e.is_user_annotation() if hasattr(e, "is_user_annotation") else name.startswith(
        "port_bench.")
    if on_device:
        if user:
            return "gpu_user_annotation"
        return ("gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
    return "user_annotation" if user else "cpu_op"


def events_of(prof) -> list[dict]:
    """The profiler's events as dicts: name, kind (the activity type), start
    and end in ns."""
    out = []
    for e in prof.profiler.kineto_results.events():
        out.append({"name": e.name(), "kind": _kind(e), "start": e.start_ns(),
                    "end": e.start_ns() + e.duration_ns()})
    return out


@contextlib.contextmanager
def profiled(enabled: bool):
    """A profiler over the block (CPU and CUDA activity) when ``enabled``;
    yields a holder whose ``trace`` is the block's ``Trace`` afterwards."""
    holder = type("Held", (), {"trace": None})()
    if not enabled:
        yield holder
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield holder
    holder.trace = Trace(events_of(prof))


def span(name: str):
    """A host span of the harness, visible in the trace."""
    return torch.profiler.record_function(name)
