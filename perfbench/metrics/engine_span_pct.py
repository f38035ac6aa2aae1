"""``engine_span_pct``: host seconds inside the program's
``ffcz.engine.correct`` spans over host seconds inside the calls' root
spans, over the traced cycle (``repro_torch.tracing``): the program's own
twin of ``engine_share_pct``, with no fence around ``correct`` and no
closing synchronise after the call."""

from perfbench import spans


def read(run):
    recs = spans.records(run)
    if not recs:
        return None
    inside = spans.named(recs, "ffcz.engine.correct")
    if not inside:
        return None
    return 100.0 * spans.host_s(inside) / spans.host_s(spans.roots(recs))
