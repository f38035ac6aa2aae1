"""``setup_s``: seconds from the start of ``run.py`` to the opening of the
window: imports, the kernels' build or load, the inputs made on the card,
and the warm-up calls (host clock)."""


def read(run):
    return run.setup_s
