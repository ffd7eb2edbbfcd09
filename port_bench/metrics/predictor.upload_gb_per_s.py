"""predictor.upload_gb_per_s: the rate of ``Predictor.score_table``'s
upload: the bytes of the host columns it copied to the device (counted
where each column is copied, ``Predictor.uploaded_bytes``, and on the span)
over the host time of its ``score.upload`` spans (the padding and the
copies from pageable memory), over the window (``Predictor.spans``)."""

UNIT = "GB/s"
LAYER = "Predictor (inference/predictor.py)"
MOVES = "score_rows_per_s"


def read(run):
    pred = getattr(run.job, "predictor", None)
    spans = getattr(pred, "spans", None)
    if run.kind != "score" or run.trace is None or spans is None:
        return None
    up = spans.totals().get("score.upload")
    if not up or not up["bytes"] or up["host_s"] <= 0:
        run.note("predictor.upload_gb_per_s: no score.upload span with bytes in the window")
        return None
    run.note(f"predictor.upload_gb_per_s: {up['bytes']} bytes in {up['calls']} uploads over "
             f"{up['host_s']:.6f} s of host ({up['device_s']:.6f} s of device); "
             f"{run.stats['steps']} calls in the window; uploaded_bytes "
             f"{pred.uploaded_bytes} since the Predictor was built")
    return up["bytes"] / up["host_s"] * 1e-9
