"""``correction_roofline_pct``: the least time of the profiled calls'
corrections (each pencil's own iterations: a full pass is the forward
and inverse real FFT and both clips, a converged pencil's last iteration
the forward FFT and the f-clip's check; its values read once and written
once: ``counts.correction_work``) over the device time inside
``CorrectionEngine.correct`` (``torch.profiler``)."""

from perfbench import counts


def read(run):
    t = run.timeline
    if t is None or t.correct_s <= 0 or not run.profiled:
        return None
    n_bytes, flops = counts.correction_work((c["block"], c["pencils"], c["iterations"], c["converged"])
                                            for c in run.profiled)
    return 100.0 * counts.least_seconds(n_bytes, flops)[0] / t.correct_s
