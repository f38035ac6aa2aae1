"""``loop_roofline_pct``: the least time of the pencil loops' work
(``counts.correction_work`` of each ``ffcz.loop`` span's ``block``,
``rows``, ``iterations`` and ``converged``) over the device time of the
work launched inside those spans, over the traced cycle
(``repro_torch.tracing``; ``spans.device_s``): ``correction_roofline_pct``
with the engine's packing and unpacking left out of the time."""

from perfbench import counts, spans


def read(run):
    recs = spans.records(run)
    loops = spans.named(recs or [], "ffcz.loop")
    seconds = spans.device_s(run, ("ffcz.loop",)) if loops else None
    if not seconds:
        return None
    n_bytes, flops = counts.correction_work((c["block"], c["rows"], c["iterations"], c["converged"])
                                            for c in (r["counts"] for r in loops))
    return 100.0 * counts.least_seconds(n_bytes, flops)[0] / seconds
