# NOTE: deliberately no XLA_FLAGS here — smoke tests and benches must see the
# real single CPU device.  Multi-device distribution tests run in a
# subprocess that sets xla_force_host_platform_device_count itself
# (tests/test_distributed.py).
import os

import numpy as np
import pytest

# Deterministic hypothesis profile for CI: fixed derivation (derandomize) so
# the randomized conformance suite reproduces identically across runs and
# pytest-xdist workers, with a CI-scoped example budget.  Loaded whenever CI
# is set (GitHub Actions exports CI=true); override with HYPOTHESIS_PROFILE.
# Tests that pass their own @settings keep those values — the profile fills
# the unspecified ones.
try:
    from hypothesis import settings as _hyp_settings

    _hyp_settings.register_profile(
        "ci", max_examples=20, derandomize=True, deadline=None, print_blob=True
    )
    if os.environ.get("CI"):
        _hyp_settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "ci"))
except ModuleNotFoundError:
    pass


def pytest_configure(config):
    # The chaos suite tags itself with @pytest.mark.timeout (a no-hang bound
    # enforced when pytest-timeout is installed, e.g. in CI).  Register the
    # marker so environments without the plugin run warning-free.
    config.addinivalue_line(
        "markers", "timeout(seconds): per-test wall-clock bound (pytest-timeout)"
    )
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
