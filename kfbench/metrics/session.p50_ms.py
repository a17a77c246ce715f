"""session.p50_ms: the median of the measured window's per-frame spans
(host clock around each `pipeline()` call), in ms. Beside frame_ms, a
steadier reading of the same path."""

import statistics


def read(ctx):
    spans = ctx.get("spans_ms") or []
    return statistics.median(spans) if spans else None
