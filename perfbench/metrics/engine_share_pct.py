"""``engine_share_pct``: the share of the window's call time spent inside
``CorrectionEngine.correct``, fenced on both sides by the benchmark's
wrapper (host clock, traced runs)."""


def read(run):
    if not run.window_calls:
        return None
    inside = sum(c["seconds"] for call in run.window_calls for c in call)
    return 100.0 * inside / sum(run.latencies)
