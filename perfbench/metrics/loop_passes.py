"""``loop_passes``: the pencil loop's passes a call, averaged over the
window's calls: each call's largest per-pencil iteration count over its
``correct`` calls (``BatchCorrectionStats.block_iterations``)."""


def read(run):
    calls = [call for call in run.window_calls if call]
    if not calls:
        return None
    return sum(max(c["passes"] for c in call) for call in calls) / len(calls)
