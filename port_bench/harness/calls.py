"""The hand-written kernels' calls in a window and the least time each could
take (the yardstick's), for the per-layer readers. Calls come from the
port's launch counters, divided by the launches one call makes; a counter
that does not divide evenly gives no reading."""

from __future__ import annotations

from harness import yardstick as ys

TABLE_GRAD_KERNELS = (r"ctr::(slice_sums|reduce_slices|make_keys|digit_scan|key_hist"
                      r"|key_scatter|chunk_sums|row_sums)\b")
ATTENTION_KERNELS = r"ctr::enc::attention_"
HAND_WRITTEN = r"\bctr::"


def _calls(run, wrapper: str, per_call: int) -> int | None:
    n = run.stats["counters"].get(wrapper, 0)
    if per_call <= 0 or n % per_call:
        run.note(f"{wrapper}: {n} launches are not whole calls of {per_call}")
        return None
    return n // per_call


def _encoder_dims(run) -> tuple[int, int, int, int, int]:
    s = run.sizes
    return run.batch, s["max_len"], s["embedding_dim"], s["attn_num_heads"], s["attn_num_layers"]


def table_grad_ms(run) -> float | None:
    """The least time of the window's table-gradient calls, ms."""
    lpc = run.launches_per_call["table_grad"]
    shapes = ys.tg_step_shapes(run.sizes, run.batch)
    steps = _calls(run, "table_grad", sum(lpc(*sh) for sh in shapes))
    if steps is None:
        return None
    return steps * sum(ys.bound(ys.table_grad(*sh), 0)["bound_ms"] for sh in shapes)


def attention_ms(run) -> float | None:
    """The least time of the window's encoder attention, ms: a layer's
    forward a forward call, its recomputed forward and backward a backward
    call."""
    if run.sizes.get("seq_pooling") != "attention":
        return None
    b, s, e, h, layers = _encoder_dims(run)
    lpc = run.launches_per_call
    fwd = _calls(run, "encode_fwd", lpc["encode_fwd"](layers))
    bwd = _calls(run, "encode_bwd", lpc["encode_bwd"](layers))
    if fwd is None or bwd is None or fwd + bwd == 0:
        return None
    t = fwd * layers * ys.attention_bound_ms(*ys.attention_fwd(b, s, e, h))
    return t + bwd * layers * ys.attention_bound_ms(*ys.attention_bwd(b, s, e, h))


def hand_written_ms(run) -> float | None:
    """The least time of every hand-written call of the window, ms."""
    s, lpc, b = run.sizes, run.launches_per_call, run.batch
    f, e = s["fields"], s["embedding_dim"]
    h1, h2 = s["hidden_units"]
    total = 0.0
    for wrapper, per_call, cost in (
            ("interaction_fwd", lpc["interaction_fwd"], ys.interaction_fwd(b, f, e)),
            ("interaction_bwd", lpc["interaction_bwd"], ys.interaction_bwd(b, f, e)),
            ("score_fwd", lpc["score_fwd"], ys.fused_score(b, f, e, h1, h2))):
        n = _calls(run, wrapper, per_call)
        if n is None:
            return None
        total += n * ys.bound(*cost)["bound_ms"]
    if s.get("seq_pooling") == "attention":
        _, sl, _, _, layers = _encoder_dims(run)
        for wrapper, cost in (("encode_fwd", ys.encoder_fwd(b, sl, e, layers)),
                              ("encode_bwd", ys.encoder_bwd(b, sl, e, layers))):
            n = _calls(run, wrapper, lpc[wrapper](layers))
            if n is None:
                return None
            total += n * ys.bound(*cost)["bound_ms"]
    if run.kind == "train":
        tg = table_grad_ms(run)
        if tg is None:
            return None
        total += tg
    return total


def roofline_pct(run, bound_ms: float | None, pattern: str) -> float | None:
    """100 x the least time over the device time of the kernels matching
    ``pattern``: None where either is missing."""
    if bound_ms is None or run.trace is None:
        return None
    t = run.trace.seconds(run.trace.kernels(pattern)) * 1e3
    if t <= 0.0:
        run.note(f"no kernel matching {pattern!r} in the trace")
        return None
    return 100.0 * bound_ms / t
