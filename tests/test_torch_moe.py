"""The port's MoE layer and MoE models against the reference's, on the CPU.

Same numpy inputs and the reference's parameters in both packages.

  * Routing: the dispatch is held as integers.  The reference's slots are
    read back from its own dispatch buffer (``moe_apply``'s first expert
    product receives it): every slot holds one token row or zeros, so the
    buffer names the token in each (expert, capacity) slot.  The port's
    ``tok_slot`` must equal it, and its ``keep``/``slot_e``/``slot_c`` must
    place every kept pair in the slot that holds its token, with the
    dropped pairs in the spare slot.  ``torch.topk`` and ``lax.top_k`` may
    order equal logits differently, so the inputs are random normals: no
    two router logits of a token tie.
  * Outputs: atol 1e-5 against the reference's ``moe_apply`` and against
    the dense oracle ``moe_ref`` without drops (the reference's own bar,
    ``tests/test_moe.py``), with and without the shared expert.
  * Models: granite-moe-3b-a800m and llama4-maverick-400b-a17b (interleaved
    dense/MoE groups, shared expert) at SMOKE, see ``test_torch_lm_parity.py``; the
    full llama4 config does not fit one card and runs only here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm_parity as lm
from repro.configs import get_config as r_get_config
from repro.models import moe as r_moe
from repro_torch.configs import get_config
from repro_torch.models import moe as t_moe

D, F, E = 32, 64, 8


def _params(shared=False, e_pad=None, seed=0):
    p = r_moe.moe_init(jax.random.PRNGKey(seed), D, F, E, shared, jnp.float32, n_experts_padded=e_pad)
    p = jax.tree.map(np.asarray, p)
    return p, jax.tree.map(lambda a: torch.from_numpy(a.copy()), p)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape + (D,)).astype(np.float32)


def _ref_apply(p, x, top_k, cf, monkeypatch):
    """The reference's output and its dispatch buffer (E_pad, C, d)."""
    seen = []
    real = jnp.einsum

    def spy(eq, *ops, **kw):
        if eq == "ecd,edf->ecf" and not seen:
            seen.append(np.asarray(ops[0]))
        return real(eq, *ops, **kw)

    monkeypatch.setattr(jnp, "einsum", spy)
    out = np.asarray(r_moe.moe_apply(p, jnp.asarray(x), top_k=top_k, capacity_factor=cf))
    monkeypatch.setattr(jnp, "einsum", real)
    return out, seen[0]


def _slots_from_buffer(buf, tokens):
    """The token in each slot of a dispatch buffer (T for an empty slot)."""
    rows = {tokens[t].tobytes(): t for t in range(tokens.shape[0])}
    zero = np.zeros(tokens.shape[1], np.float32).tobytes()
    out = np.full(buf.shape[:2], tokens.shape[0], dtype=np.int64)
    for e in range(buf.shape[0]):
        for c in range(buf.shape[1]):
            row = buf[e, c].tobytes()
            if row != zero:
                out[e, c] = rows[row]
    return out


CASES = [(1, 8.0, (2, 16)), (2, 8.0, (2, 16)), (4, 8.0, (2, 16)), (2, 0.5, (4, 32)), (1, 1.0, (4, 32))]


@pytest.mark.parametrize("top_k,cf,shape", CASES, ids=str)
def test_routing_equals_the_references_as_integers(top_k, cf, shape, monkeypatch):
    p, tp = _params(e_pad=16)
    x = _x(shape)
    _, buf = _ref_apply(p, x, top_k, cf, monkeypatch)
    tokens = x.reshape(-1, D)
    T = tokens.shape[0]
    want = _slots_from_buffer(buf, tokens)
    r = t_moe.route(tp["router"], torch.from_numpy(tokens), top_k=top_k, capacity_factor=cf, e_pad=16)
    assert r.capacity == buf.shape[1] == r_moe.capacity_of(T, top_k, E, cf)
    np.testing.assert_array_equal(r.tok_slot.numpy(), want)
    keep, slot_e, slot_c, sorted_t = (a.numpy() for a in (r.keep, r.slot_e, r.slot_c, r.sorted_t))
    assert keep.sum() == (want < T).sum()
    np.testing.assert_array_equal(want[slot_e[keep], slot_c[keep]], sorted_t[keep])
    assert (slot_e[~keep] == 16).all() and (slot_c[~keep] == r.capacity).all()
    assert (np.diff(slot_e[keep]) >= 0).all()  # the stable sort: pairs grouped by expert
    if cf < 1.0:
        assert not keep.all()  # the tight case drops pairs


@pytest.mark.parametrize("top_k,cf,shape", CASES, ids=str)
def test_moe_apply_matches_reference(top_k, cf, shape, monkeypatch):
    p, tp = _params(e_pad=16)
    x = _x(shape)
    want, _ = _ref_apply(p, x, top_k, cf, monkeypatch)
    got = t_moe.moe_apply(tp, torch.from_numpy(x), top_k=top_k, capacity_factor=cf).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_no_drop_dispatch_matches_the_dense_oracle(top_k, shared):
    p, tp = _params(shared=shared)
    x = _x((2, 16))
    got = t_moe.moe_apply(tp, torch.from_numpy(x), top_k=top_k, capacity_factor=8.0).numpy()
    oracle = t_moe.moe_ref(tp, torch.from_numpy(x), top_k=top_k).numpy()
    want = np.asarray(r_moe.moe_ref(p, jnp.asarray(x), top_k=top_k))
    np.testing.assert_allclose(got, oracle, atol=1e-5, rtol=0)
    np.testing.assert_allclose(oracle, want, atol=1e-5, rtol=0)


def test_shared_expert_matches_reference(monkeypatch):
    p, tp = _params(shared=True)
    assert set(tp["shared"]) == {"w_gu", "w_down"}
    x = _x((1, 8))
    want, _ = _ref_apply(p, x, 1, 8.0, monkeypatch)
    got = t_moe.moe_apply(tp, torch.from_numpy(x), top_k=1, capacity_factor=8.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_tokens,top_k,n_experts,cf", [(1000, 2, 8, 1.25), (1, 1, 64, 1.0), (8192, 8, 40, 1.25),
                                                         (37, 3, 5, 0.5)])
def test_capacity_of_is_the_references(n_tokens, top_k, n_experts, cf):
    got = t_moe.capacity_of(n_tokens, top_k, n_experts, cf)
    assert got == r_moe.capacity_of(n_tokens, top_k, n_experts, cf) and got % 8 == 0


def test_gradients_are_finite_and_reach_the_router():
    _, tp = _params(shared=True)
    tp = {k: (v.requires_grad_() if isinstance(v, torch.Tensor) else
              {kk: vv.requires_grad_() for kk, vv in v.items()}) for k, v in tp.items()}
    x = torch.from_numpy(_x((2, 16))).requires_grad_()
    torch.sum(t_moe.moe_apply(tp, x, top_k=2, capacity_factor=0.5) ** 2).backward()
    grads = [tp[k].grad for k in ("router", "w_gate", "w_up", "w_down")] + [
        tp["shared"]["w_gu"].grad, tp["shared"]["w_down"].grad, x.grad]
    assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads)
    assert float(tp["router"].grad.abs().max()) > 0  # the router is trained through the weights


def test_mesh_axes_raise():
    """``mesh_axes`` are layout hints: full parameters under a "model" axis
    of 2 (no tensor-parallel context) give the hint-free result bitwise,
    dropping pairs or not, with a shared expert."""
    _, tp = _params(shared=True, e_pad=16)
    x = torch.from_numpy(_x((2, 16)))
    for cf in (0.5, 4.0):
        plain = t_moe.moe_apply(tp, x, top_k=2, capacity_factor=cf)
        hinted = t_moe.moe_apply(tp, x, top_k=2, capacity_factor=cf, mesh_axes=(("data", 2), ("model", 2)))
        assert torch.equal(plain, hinted), cf


def test_module_init_follows_the_references_layout():
    m = t_moe.MoE(D, F, E, True, torch.bfloat16, n_experts_padded=16)
    m.init_(torch.Generator().manual_seed(0))
    p, _ = _params(shared=True, e_pad=16)
    got = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert got == {"router": p["router"].shape, "w_gate": p["w_gate"].shape, "w_up": p["w_up"].shape,
                   "w_down": p["w_down"].shape, "shared.w_gu": p["shared"]["w_gu"].shape,
                   "shared.w_down": p["shared"]["w_down"].shape}
    assert m.router.dtype == torch.float32 and m.w_gate.dtype == torch.bfloat16
    assert abs(float(m.w_gate.detach().float().std()) - 1 / np.sqrt(D)) < 0.01


# ---------------------------------------------------------------------------
# the MoE models

ARCHS = ["granite-moe-3b-a800m", "llama4-maverick-400b-a17b"]


@pytest.mark.parametrize("preset", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_references(arch, preset):
    ours = get_config(arch) if preset == "full" else lm.get_smoke_config(arch)
    theirs = r_get_config(arch) if preset == "full" else lm.r_get_smoke_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for prop in ("vocab_padded", "n_experts_padded", "resolved_head_dim"):
        assert getattr(ours, prop) == getattr(theirs, prop)


@pytest.mark.parametrize("impl", ["xla_flash", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch, impl):
    lm.check_loss(arch, attention_impl=impl)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    rc, tc = lm.check_prefill_decode(arch)
    assert set(tc) == set(rc) | {"pos"} and tc["pos"] == 15
    assert ("dense" in tc) == (lm.get_smoke_config(arch).moe_every > 1)
    for name in set(rc) - {"pos"}:
        for kv in ("k", "v"):
            assert tuple(tc[name][kv].shape) == rc[name][kv].shape


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_reference(arch):
    lm.check_serving(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_incremental_equals_full_without_drops(arch):
    """At capacity_factor = n_experts / top_k the capacity is at least the
    token count, so no pair is dropped in either call and the last token
    routes alike; at the default factor a full prefill may drop the last
    token's pairs (it sorts last within each expert) where a one-token
    decode never does."""
    cfg = lm.get_smoke_config(arch)
    lm.check_incremental_equals_full(arch, capacity_factor=cfg.n_experts / cfg.top_k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch, dtype):
    model = lm.check_round_trip(arch, dtype)
    cfg = lm.get_smoke_config(arch)
    g0 = model.groups[0]
    assert g0.moe_block.moe.w_gate.shape[0] == cfg.n_experts_padded  # experts padded
    assert g0.moe_block.moe.router.shape[1] == cfg.n_experts  # the router not
    assert hasattr(g0, "dense_blocks") == (cfg.moe_every > 1)


def test_compress_cache_walks_the_nested_moe_cache():
    got, cache = lm.check_compress_nested_cache("llama4-maverick-400b-a17b")
    assert set(got) == {"moe", "dense", "pos"} and got["pos"] == cache["pos"]
    assert got["dense"]["k"].ndim == 6  # (groups, moe_every - 1, b, hkv, S, hd)


def test_full_llama4_is_too_large_for_one_card():
    """The published llama4 config (about 400 B parameters, ~800 GB in bf16)
    is counted from meta tensors; it runs at SMOKE only (ROADMAP)."""
    from repro_torch.models.model import MoELM

    cfg = get_config("llama4-maverick-400b-a17b")
    n = sum(p.numel() for p in MoELM(cfg, device="meta").parameters())
    assert 3.5e11 < n < 4.6e11
