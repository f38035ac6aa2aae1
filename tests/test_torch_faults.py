"""The port's fault injector fires exactly when the reference's does.

``repro_torch.runtime.faults`` is a copy of the reference's numpy module (the
port imports nothing of ``repro``): for the same seed and the same
per-request sequence of ``fire`` calls, the same faults fire, with the same
per-(site, uid) caps, and the byte-corruption helpers give the same bytes.
"""

import inspect

import numpy as np
import pytest

import repro.runtime.faults as ref
import repro_torch.runtime.faults as port

SITES = ("codec", "dispatch", "oom", "session_journal", "session_append")


def _public(module):
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and getattr(v, "__module__", None) == module.__name__}


def test_every_public_name_of_the_reference_is_there():
    assert _public(ref) == _public(port)
    for name in _public(ref):
        assert inspect.isclass(getattr(ref, name)) == inspect.isclass(getattr(port, name))
    assert set(ref._SITE_ERRORS) == set(port._SITE_ERRORS)
    for site, exc in ref._SITE_ERRORS.items():
        assert port._SITE_ERRORS[site].__mro__[1] is exc.__mro__[1]  # OSError / RuntimeError


def _trace(module, seed, calls, **cfg):
    """The outcome of each call in ``calls`` ([(site, uid)]): None, or the
    raised error's type name and message; plus the slow draws."""
    inj = module.FaultInjector(module.FaultConfig(**cfg), seed=seed)
    out = []
    for site, uid in calls:
        if site == "slow":
            out.append(("slow", inj.sleep_s(uid=uid)))
            continue
        try:
            inj.fire(site, uid=uid)
            out.append(None)
        except Exception as e:  # noqa: BLE001 - the injected error is the outcome
            out.append((type(e).__name__, str(e)))
    return out, dict(inj.fired)


@pytest.mark.parametrize("seed", [0, 7, 20260809])
@pytest.mark.parametrize("max_per_site", [1, 2, 100])
def test_fires_exactly_when_the_reference_does(seed, max_per_site):
    rng = np.random.default_rng(seed)
    uids = [f"req-{i}" for i in range(6)] + ["sess-1#3", "dec-0", ""]
    calls = [(str(rng.choice(SITES + ("slow",))), str(rng.choice(uids))) for _ in range(400)]
    cfg = dict(p_codec=0.3, p_dispatch=0.5, p_oom=0.2, p_slow=0.25, slow_s=3.0,
               p_session_journal=0.4, p_session_append=0.6, max_per_site=max_per_site)
    got, fired = _trace(port, seed, calls, **cfg)
    want, fired_ref = _trace(ref, seed, calls, **cfg)
    assert got == want and fired == fired_ref
    assert any(g is not None and g[0] != "slow" for g in got)  # something fired


def test_interleaving_does_not_change_a_requests_faults():
    """Per-(seed, uid) substreams: the order in which requests interleave
    leaves each request's own fire sequence unchanged, in both packages."""
    cfg = dict(p_dispatch=0.5, p_codec=0.5, max_per_site=3)
    a = [("dispatch", "req-1"), ("codec", "req-1"), ("dispatch", "req-2"), ("codec", "req-2")] * 4
    b = [("dispatch", "req-2"), ("codec", "req-2")] * 4 + [("dispatch", "req-1"), ("codec", "req-1")] * 4
    for module in (port, ref):
        ga, _ = _trace(module, 3, a, **cfg)
        gb, _ = _trace(module, 3, b, **cfg)
        per = {}
        for (site, uid), g in zip(a, ga):
            per.setdefault(uid, []).append(g)
        for (site, uid), g in zip(b, gb):
            per.setdefault(uid + "'", []).append(g)
        assert per["req-1"] == per["req-1'"] and per["req-2"] == per["req-2'"]


def test_zero_probability_and_unknown_site():
    for module in (port, ref):
        inj = module.FaultInjector(seed=1)
        for site in SITES:
            inj.fire(site, uid="x")
        assert inj.sleep_s(uid="x") == 0.0
        with pytest.raises(ValueError, match="unknown fault site"):
            module.FaultConfig().probability("nope")


@pytest.mark.parametrize("seed", [0, 5, 99])
def test_corruption_helpers_give_the_same_bytes(seed):
    blob = np.random.default_rng(seed).integers(0, 256, 777, dtype=np.uint8).tobytes()
    a, b = port.FaultInjector(seed=seed), ref.FaultInjector(seed=seed)
    for _ in range(12):
        assert a.flip_bit(blob) == b.flip_bit(blob)
        assert a.truncate(blob) == b.truncate(blob)
        assert a.corrupt_blob(blob) == b.corrupt_blob(blob)
    assert a.flip_bit(blob, position=13) == b.flip_bit(blob, position=13) != blob
    assert a.truncate(blob, keep=5) == blob[:5]
    assert a.flip_bit(b"") == b""


def test_injected_oom_keeps_its_marker():
    assert str(port.InjectedOOM("boom")) == str(ref.InjectedOOM("boom")) == "RESOURCE_EXHAUSTED: boom"
