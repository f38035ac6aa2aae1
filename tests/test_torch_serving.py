"""The port's ServingEngine against the reference's, at qwen2-0.5b SMOKE.

Both engines get the same parameters (the reference's init, converted with
``convert.lm_params_from_reference``) and the same requests.  Each engine's
prefill and decode calls are recorded, and the logits compared at atol 1e-4
(float32; two layers of products summed in another order).

Token rule: greedy tokens must be equal at every step where the reference's
top-1/top-2 logit margin exceeds 1e-3.  Where the margin is smaller, the
two packages' roundings may legitimately pick different tokens; that
request's later steps then decode different prefixes and are not compared.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import CompressionConfig as RCompressionConfig
from repro.configs import get_smoke_config as r_get_smoke_config
from repro.models.model import build_model as r_build_model
from repro.serving.engine import ServeConfig as RServeConfig
from repro.serving.engine import ServingEngine as RServingEngine
from repro_torch import convert
from repro_torch.configs import CompressionConfig, get_smoke_config
from repro_torch.launch import serve as t_serve
from repro_torch.serving.engine import ServeConfig, ServingEngine

ARCH = "qwen2-0.5b"
MARGIN = 1e-3


def _engines(impl, max_batch, seed=0, kv_compression=False):
    rcfg = r_get_smoke_config(ARCH, attention_impl=impl)
    cfg = get_smoke_config(ARCH, attention_impl=impl)
    if kv_compression:
        rcfg = dataclasses.replace(rcfg, compression=RCompressionConfig(kv_cache_compression=True))
        cfg = dataclasses.replace(cfg, compression=CompressionConfig(kv_cache_compression=True))
    ref_params = jax.tree.map(np.asarray, r_build_model(rcfg).init(jax.random.PRNGKey(seed)))
    r = RServingEngine(rcfg, RServeConfig(max_batch=max_batch), params=ref_params)
    t = ServingEngine(cfg, ServeConfig(max_batch=max_batch),
                      params=convert.lm_params_from_reference(ref_params, cfg), device="cpu")
    return r, t


def _record(eng):
    """Wrap the engine's prefill/decode so each call's logits are kept."""
    logs = []

    def wrap(fn):
        def call(*args):
            logits, cache = fn(*args)
            logs.append(np.asarray(logits, dtype=np.float32)[:, -1])
            return logits, cache
        return call

    eng._prefill, eng._decode = wrap(eng._prefill), wrap(eng._decode)
    return logs


def _compare_step(r_logs, t_logs, r_tokens, t_tokens):
    """Per request row: logits at every step until the tokens part, and
    equal tokens wherever the reference's margin exceeds MARGIN."""
    assert len(r_logs) == len(t_logs)
    diverged = set()
    for step, (rl, tl) in enumerate(zip(r_logs, t_logs)):
        for row in range(rl.shape[0]):
            if row in diverged:
                continue
            np.testing.assert_allclose(tl[row], rl[row], atol=1e-4, rtol=0)
            if step >= len(r_tokens[row]):
                continue
            top2 = np.sort(rl[row])[-2:]
            if t_tokens[row][step] != r_tokens[row][step]:
                assert top2[1] - top2[0] <= MARGIN, (row, step, top2)
                diverged.add(row)
    return diverged


# (impl, prompt lengths, max_batch): prompts longer than 8 take the flash
# prefill branch (unless naive); all shorter ones take the naive branch
CASES = [
    ("xla_flash", (5, 12, 20), 4),
    ("pallas", (5, 12, 20), 4),
    ("naive", (5, 12, 20), 4),
    ("xla_flash", (3, 6, 8), 4),
    ("pallas", (9, 30, 4, 17, 11), 2),
]


@pytest.mark.parametrize("impl, lengths, max_batch", CASES, ids=str)
def test_engine_matches_reference(impl, lengths, max_batch):
    r, t = _engines(impl, max_batch)
    rng = np.random.default_rng(len(lengths))
    for n in lengths:
        prompt = rng.integers(0, 256, n)
        new = int(rng.integers(3, 7))
        assert r.submit(prompt, max_new_tokens=new) == t.submit(prompt, max_new_tokens=new)
    while r.queue:
        r_logs, t_logs = _record(r), _record(t)
        r_out, t_out = r.step(), t.step()
        assert [o["uid"] for o in r_out] == [o["uid"] for o in t_out]
        assert [len(o["tokens"]) for o in r_out] == [len(o["tokens"]) for o in t_out]
        _compare_step(r_logs, t_logs, [o["tokens"] for o in r_out], [o["tokens"] for o in t_out])
        assert len(r.queue) == len(t.queue)
    assert not t.queue


def test_engine_initialises_from_a_seed():
    cfg = get_smoke_config(ARCH)
    a = ServingEngine(cfg, ServeConfig(max_batch=1), rng_seed=5, device="cpu")
    b = ServingEngine(cfg, ServeConfig(max_batch=1), rng_seed=5, device="cpu")
    for eng in (a, b):
        eng.submit(np.arange(8), max_new_tokens=4)
    assert a.step() == b.step()


def _errors(eng, cfg):
    bad = [
        dict(prompt=np.array([], dtype=np.int32)),
        dict(prompt=np.zeros((2, 3), dtype=np.int32)),
        dict(prompt=np.array([0, cfg.vocab], dtype=np.int32)),
        dict(prompt=np.array([-1, 0], dtype=np.int32)),
        dict(prompt=np.arange(4), max_new_tokens=0),
        dict(prompt=np.zeros(eng.serve.max_len + 1, dtype=np.int32)),
    ]
    out = []
    for kw in bad:
        with pytest.raises(ValueError) as e:
            eng.submit(**kw)
        out.append(str(e.value))
    assert not eng.queue
    return out


def test_submit_validation_is_the_references():
    r, t = _engines("xla_flash", 2)
    assert _errors(t, t.cfg) == _errors(r, r.cfg)


@pytest.mark.parametrize("impl, lengths, max_batch", [CASES[0], CASES[4]], ids=str)
def test_engine_with_kv_compression_matches_reference(impl, lengths, max_batch):
    """KV compression after prefill on both engines (the reference's default
    engine: batched, fft_impl="xla"): per-step logits at atol 1e-4 with the
    same token rule as without compression.  The compressed caches agree to
    float32 rounding (test_torch_kv_compress.py), so the bar is unchanged."""
    r, t = _engines(impl, max_batch, kv_compression=True)
    assert dataclasses.asdict(t.cfg.compression) == dataclasses.asdict(r.cfg.compression)
    rng = np.random.default_rng(7)
    for n in lengths:
        prompt = rng.integers(0, 256, n)
        r.submit(prompt, max_new_tokens=4)
        t.submit(prompt, max_new_tokens=4)
    while r.queue:
        r_logs, t_logs = _record(r), _record(t)
        r_out, t_out = r.step(), t.step()
        assert [o["uid"] for o in r_out] == [o["uid"] for o in t_out]
        _compare_step(r_logs, t_logs, [o["tokens"] for o in r_out], [o["tokens"] for o in t_out])
    assert not t.queue


def test_engine_has_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(get_smoke_config(ARCH), ServeConfig())


def test_serve_cli_on_the_cpu(capsys):
    t_serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3", "--max-new-tokens", "2",
                  "--max-batch", "2"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and out.count("uid=") == 3


def test_serve_cli_with_kv_compression_on_the_cpu(capsys):
    t_serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2", "--max-new-tokens", "3",
                  "--max-batch", "2", "--kv-compression"])
    out = capsys.readouterr().out
    assert "served 2 requests" in out and out.count("uid=") == 2
