"""Field configurations of the paper's experiments (see :mod:`.ffcz_fields`)."""
