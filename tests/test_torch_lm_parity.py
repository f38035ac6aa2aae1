"""Shared checks of a port LM against the reference's at an arch's SMOKE config.

A module of helpers, not of tests (no ``test_`` names): the test files
import it.

Used by ``test_torch_models.py`` (the dense configs), ``test_torch_moe.py``,
``test_torch_ssm.py``, ``test_torch_hybrid.py``, ``test_torch_vlm.py`` and
``test_torch_whisper.py``.  Both packages get the reference's parameters
(``convert.lm_params_from_reference``) and the same numpy tokens (and, for
the vlm and audio families, the same numpy ``patches`` or ``frames``: see
:func:`batch`).  Tolerances, float32 throughout:

  * loss rtol 1e-5; prefill and decode logits atol 1e-4 (a few layers of
    float32 products summed in another order; the same bars as the dense
    slice's);
  * greedy ServingEngine tokens equal wherever the reference's top-1/top-2
    logit margin exceeds 1e-3 (below it either pick is right; that request
    is not compared further), logits atol 1e-4 at every compared step;
  * incremental decoding against the full forward: atol 1e-4;
  * parameter round trips bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import CompressionConfig as RCompressionConfig
from repro.configs import get_smoke_config as r_get_smoke_config
from repro.models.model import build_model as r_build_model
from repro.serving.engine import ServeConfig as RServeConfig
from repro.serving.engine import ServingEngine as RServingEngine
from repro.serving.kv_compress import compress_cache as r_compress_cache
from repro_torch import convert
from repro_torch.configs import CompressionConfig, get_smoke_config
from repro_torch.core.engine import CorrectionEngine
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import build_model
from repro_torch.serving.engine import ServeConfig, ServingEngine
from repro_torch.serving.kv_compress import compress_cache

MARGIN = 1e-3


def configs(arch, **overrides):
    return r_get_smoke_config(arch, **overrides), get_smoke_config(arch, **overrides)


def ref_params(rcfg, seed=0):
    return jax.tree.map(np.asarray, r_build_model(rcfg).init(jax.random.PRNGKey(seed)))


def port_model(cfg, params_np):
    bundle = build_model(cfg, device="cpu")
    return bundle, bundle.load(convert.lm_params_from_reference(params_np, cfg))


def tokens(cfg, b=2, s=40, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def stubs(cfg, b=2, seed=2):
    """The family's stub frontend output, standard normal float32 numpy:
    ``patches`` (vlm), ``frames`` (audio), nothing for the other families."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"patches": rng.standard_normal((b, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)}
    if cfg.family == "audio":
        return {"frames": rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}
    return {}


def batch(cfg, toks, seed=2):
    """``{"tokens": toks}`` with the family's :func:`stubs` for its rows."""
    return {"tokens": toks, **stubs(cfg, toks.shape[0], seed)}


def jnp_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def vision(cfg):
    """Cache entries a vlm prefill writes before the prompt's."""
    return cfg.vision_tokens if cfg.family == "vlm" else 0


def as_np(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def check_loss(arch, **overrides):
    rcfg, cfg = configs(arch, **overrides)
    params_np = ref_params(rcfg)
    toks = tokens(cfg)
    b = batch(cfg, toks)
    want = float(r_build_model(rcfg).loss(params_np, jnp_batch(b)))
    bundle, params = port_model(cfg, params_np)
    got = float(bundle.loss(params, b).detach())
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    return bundle, params, toks


def check_prefill_decode(arch, steps=3, **overrides):
    """Prefill from zero, then ``steps`` decode steps, against the reference's."""
    rcfg, cfg = configs(arch, **overrides)
    params_np = ref_params(rcfg)
    rb = r_build_model(rcfg)
    tb, params = port_model(cfg, params_np)
    toks = tokens(cfg, b=2, s=12, seed=4)
    b = batch(cfg, toks)
    n = vision(cfg) + 12 + steps + 1
    rc, tc = rb.init_cache(2, n), tb.init_cache(2, n)
    rl, rc = rb.prefill(params_np, jnp_batch(b), rc)
    tl, tc = tb.prefill(params, b, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), atol=1e-4, rtol=0)
    for t in range(steps):
        nxt = np.full((2, 1), 7 + t, dtype=np.int32)
        rl, rc = rb.decode(params_np, jnp.asarray(nxt), rc)
        tl, tc = tb.decode(params, nxt, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), atol=1e-4, rtol=0)
    return rc, tc


def check_incremental_equals_full(arch, **overrides):
    """Prefill s - 1 tokens and decode the last: the logits of a prefill of
    all s (the reference's ``test_incremental_equals_full``, float32)."""
    _, cfg = configs(arch, attention_impl="naive", **overrides)
    bundle = build_model(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    toks = tokens(cfg, b=1, s=12, seed=5)
    n = vision(cfg) + 12
    full, _ = bundle.prefill(params, batch(cfg, toks), bundle.init_cache(1, n))
    _, cache = bundle.prefill(params, batch(cfg, toks[:, :11]), bundle.init_cache(1, n))
    step, _ = bundle.decode(params, toks[:, 11:], cache)
    np.testing.assert_allclose(step[:, -1].numpy(), full[:, -1].numpy(), atol=1e-4, rtol=0)


def check_round_trip(arch, dtype, **overrides):
    """reference tree -> port state dict -> port model -> reference tree, bitwise."""
    rcfg, cfg = configs(arch, dtype=dtype, **overrides)
    params_np = ref_params(rcfg)
    bundle, model = port_model(cfg, params_np)
    assert all(p.dtype in (dtype_of(dtype), torch.float32) for p in model.parameters())
    back = jax.tree.map(as_np, convert.lm_params_to_reference(model.state_dict(), cfg))
    flat_a, tree_a = jax.tree.flatten(params_np)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a.view(np.uint8), b.view(np.uint8))
    return model


def _record(eng):
    logs = []

    def wrap(fn):
        def call(*args):
            logits, cache = fn(*args)
            logs.append(np.asarray(logits, dtype=np.float32)[:, -1])
            return logits, cache
        return call

    eng._prefill, eng._decode = wrap(eng._prefill), wrap(eng._decode)
    return logs


def check_serving(arch, kv_compression=False, max_batch=2, **overrides):
    """Both ServingEngines on the same 4 requests: per-step logits and greedy tokens."""
    rcfg, cfg = configs(arch, **overrides)
    if kv_compression:
        rcfg = dataclasses.replace(rcfg, compression=RCompressionConfig(kv_cache_compression=True))
        cfg = dataclasses.replace(cfg, compression=CompressionConfig(kv_cache_compression=True))
    params_np = ref_params(rcfg)
    r = RServingEngine(rcfg, RServeConfig(max_batch=max_batch), params=params_np)
    t = ServingEngine(cfg, ServeConfig(max_batch=max_batch),
                      params=convert.lm_params_from_reference(params_np, cfg), device="cpu")
    r_logs, t_logs = _record(r), _record(t)
    rng = np.random.default_rng(3)
    for _ in range(4):
        prompt = rng.integers(0, cfg.vocab, int(rng.integers(3, 14)))
        r.submit(prompt, max_new_tokens=5)
        t.submit(prompt, max_new_tokens=5)
    compared = 0
    while r.queue:
        n_logs = len(r_logs)
        r_out, t_out = r.step(), t.step()
        assert [o["uid"] for o in r_out] == [o["uid"] for o in t_out]
        diverged = set()
        for step, (rl, tl) in enumerate(zip(r_logs[n_logs:], t_logs[n_logs:])):
            for row in range(rl.shape[0]):
                if row in diverged:
                    continue
                np.testing.assert_allclose(tl[row], rl[row], atol=1e-4, rtol=0)
                if t_out[row]["tokens"][step] != r_out[row]["tokens"][step]:
                    top2 = np.sort(rl[row])[-2:]
                    assert top2[1] - top2[0] <= MARGIN, (row, step, top2)
                    diverged.add(row)
                else:
                    compared += 1
        assert len(r_logs) == len(t_logs)
    assert compared >= 10


def port_cache(ref_cache, pos, at=()):
    """The port's layout of a reference cache: the same leaves as tensors
    (a tuple of leaves stays a tuple), the per-layer ``pos`` arrays dropped
    for one int ``pos`` in the subtree at path ``at`` (the top; whisper's
    ``("self",)``)."""
    def tensor(v):
        return tuple(map(tensor, v)) if isinstance(v, tuple) else torch.from_numpy(np.array(v))

    def walk(node, path):
        out = {k: walk(v, path + (k,)) if isinstance(v, dict) else tensor(v)
               for k, v in node.items() if k != "pos"}
        return {**out, "pos": pos} if pos is not None and path == at else out

    return walk(ref_cache, ())


def kv_paths(cache, path=()):
    """Paths of the ``k``/``v`` leaves of a nested cache (sorted keys)."""
    for k in sorted(cache):
        v = cache[k]
        if isinstance(v, dict):
            yield from kv_paths(v, path + (k,))
        elif k in ("k", "v"):
            yield path + (k,)


def leaf(cache, path):
    for k in path:
        cache = cache[k]
    return cache


def check_compress_nested_cache(arch, block=32, Delta_rel=1e-4):
    """``compress_cache`` on a prefilled reference cache of ``arch``: every
    k/v leaf of the nested cache compressed (ONE correct call over all
    their sub-tensors, as many as the reference's), each value within its
    sub-tensor's E, every full pencil's spectrum within Delta * (1 + 1e-5)
    + tau, the output within float32 rounding of the reference's, and every
    other leaf (mamba conv and state) untouched.  Returns the calls."""
    rcfg, cfg = configs(arch)
    params_np = ref_params(rcfg)
    rb = r_build_model(rcfg)
    toks = tokens(cfg, b=2, s=40, seed=6)
    rcache = rb.init_cache(2, vision(cfg) + 48)
    _, rcache = rb.prefill(params_np, jnp_batch(batch(cfg, toks)), rcache)
    rcomp = RCompressionConfig(kv_cache_compression=True, kv_Delta_rel=Delta_rel)
    comp = CompressionConfig(kv_cache_compression=True, kv_Delta_rel=Delta_rel)
    want = r_compress_cache(rcache, rcomp, block=block)
    cache = port_cache(rcache, vision(cfg) + 40, at=("self",) if cfg.family == "audio" else ())

    engine = CorrectionEngine(backend="batched", device="cpu")
    calls = []
    correct = engine.correct

    def recording(errs, Es, Ds, **kw):
        out = correct(errs, Es, Ds, **kw)
        calls.append((errs, Es, Ds, out[0]))
        return out

    engine.correct = recording
    got = compress_cache(cache, comp, block=block, engine=engine)
    assert len(calls) == 1
    errs, Es, Ds, corrected = calls[0]
    paths = list(kv_paths(cache))
    n_sub = sum(int(np.prod(leaf(cache, p).shape[:-4])) if leaf(cache, p).ndim > 4 else 1 for p in paths)
    assert len(errs) == n_sub and len(paths) >= 2
    for c, E, D in zip(corrected, Es, Ds):
        x = c.numpy().astype(np.float64).reshape(-1)
        assert np.abs(x).max() <= float(E)
        full = x[: x.size // block * block].reshape(-1, block)
        spec = np.fft.rfft(full, axis=-1)
        mag = np.maximum(np.abs(spec.real), np.abs(spec.imag)).max(axis=1)
        tau = 5 * 2.0**-24 * np.log2(block) * np.sqrt(block) * np.sqrt((full * full).sum(axis=1))
        assert np.all(mag <= float(D) * (1 + 1e-5) + tau)
    for p in paths:
        g, w, x = leaf(got, p).numpy(), np.asarray(leaf(want, p)), leaf(cache, p).numpy()
        assert g.shape == w.shape == x.shape and g.dtype == w.dtype
        assert not np.array_equal(g, x)  # compressed: the correction acts at this Delta
        np.testing.assert_allclose(g, w, atol=1e-6 * float(np.abs(w).max()), rtol=0)

    def others(node, path=()):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from others(v, path + (k,))
            elif k not in ("k", "v"):
                yield path + (k,)

    for p in others(cache):
        assert leaf(got, p) is leaf(cache, p)
    return got, cache
