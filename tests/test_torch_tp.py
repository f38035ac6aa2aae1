"""Tensor and expert parallelism over a mesh's "model" axis, on gloo ranks.

One module-scoped fixture builds the inputs here (the port's initial
parameters, float32 SMOKE configs, numpy batches), spawns
``_torch_ranks.body_tp`` once per world size (2: a (1, 2) mesh; 4: (2, 2)
and (1, 4); 8: (4, 2), the reference's own ``test_distributed.py`` mesh),
and runs the JAX reference's single-device steps while the ranks work.

- Every family (qwen2-0.5b, granite-moe-3b-a800m at a capacity factor that
  drops pairs, mamba2-2.7b, zamba2-7b, llava-next-mistral-7b,
  whisper-tiny) on (1, 2) and (2, 2); qwen2-0.5b on (1, 4), where its 4
  query and 2 kv heads do not split (the replicated-attention branch, a
  cache split on ``head_dim``), and on (4, 2).
- Against the reference's one-device step on the same parameters and
  batches: the loss of two steps within rtol 1e-5, every gathered
  parameter after them within 1e-4 (scaled by the leaf's magnitude above
  1), the first step's gathered gradients within rtol 1e-5 and 1e-5 of each
  leaf's largest value; the MoE routing's kept and dropped pairs equal, as
  integers, to the reference's routing of the same layer inputs.
- Per rank: state bytes equal to the rules' share; AdamW's global norm
  within rtol 1e-6 of the gathered gradients' (every element counted once).
- ``MeshServe`` prefill and two decode steps, gathered over rows and
  vocab, within 1e-5 (of the logits' largest magnitude) of the one-device
  bundle's.
- ``compress_sharded_gradients`` at every mesh shape bitwise the
  one-device ``compress_gradients`` on the same gradients.
- A mesh Trainer's checkpoint restores bitwise on the same mesh, decoded
  by data rank 0 of model rank 0 alone, which scatters each leaf's blocks.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
import test_torch_lm_parity as lm
from repro.models import model as r_model
from repro.models.moe import capacity_of as r_capacity_of
from repro.optim.adamw import AdamW as RAdamW
from repro_torch import convert
from repro_torch.core.engine import CorrectionEngine
from repro_torch.models import transformer as t_transformer
from repro_torch.optim import compress_gradients

BATCH, SEQ = 4, 24
CASES = [("dense", "qwen2-0.5b", {}), ("moe", "granite-moe-3b-a800m", {"capacity_factor": 0.5}),
         ("ssm", "mamba2-2.7b", {}), ("hybrid", "zamba2-7b", {}), ("vlm", "llava-next-mistral-7b", {}),
         ("audio", "whisper-tiny", {})]
LABELS = [c[0] for c in CASES]
#: world size -> [(mesh shape, cases)]
MESHES = {2: [((1, 2), LABELS)], 4: [((2, 2), LABELS), ((1, 4), ["dense"])], 8: [((4, 2), ["dense"])]}
KEYS = [(shape, label) for world in MESHES for shape, labels in MESHES[world] for label in labels]
COMPRESS = dict(bits=8, E_rel=1e-2, Delta_rel=5e-5, block=512)
COMPRESS_LABELS = ("dense", "moe", "hybrid")
COMPRESS_KEYS = [(shape, label) for shape, label in KEYS if label in COMPRESS_LABELS]
PROMPT, NEW = 6, 2
CHECKPOINT_MESHES = [(1, 2), (2, 2), (1, 4)]


def _world(shape):
    return shape[0] * shape[1]


def _id(key):
    return f"{key[0][0]}x{key[0][1]}-{key[1]}"


def _state(cfg, seed=0):
    model = lm.build_model(cfg, device="cpu").init(torch.Generator().manual_seed(seed))
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _batch(cfg, seed):
    return lm.batch(cfg, lm.tokens(cfg, b=BATCH, s=SEQ, seed=seed), seed=seed + 10)


def _reference(case):
    """The reference's two one-device steps (JAX on the CPU): losses, the
    first step's gradients and the parameters after the second, by port
    name."""
    label, arch, overrides, state, batches = case
    rcfg, cfg = lm.configs(arch, **overrides)
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), convert.lm_params_to_reference(
        {k: torch.from_numpy(v) for k, v in state.items()}, cfg))
    bundle, opt = r_model.build_model(rcfg), RAdamW(warmup_steps=2)

    @jax.jit
    def step(p, o, b):
        loss, grads = jax.value_and_grad(bundle.loss)(p, b)
        p, o = opt.update(grads, o, p)
        return p, o, loss, grads

    def port(tree):
        return {k: np.asarray(v) for k, v in convert.lm_params_from_reference(jax.tree.map(np.asarray, tree),
                                                                              cfg).items()}

    o, losses = opt.init(params), []
    for i, b in enumerate(batches):
        params, o, loss, grads = step(params, o, lm.jnp_batch(b))
        losses.append(float(loss))
        if i == 0:
            first = port(grads)
    return {"losses": losses, "grads": first, "params": port(params)}


def _reference_routing(cfg, state, batch):
    """(kept, pairs) of each MoE layer of the one-device forward, routed by
    the reference's arithmetic (``lax.top_k``, a stable sort, the capacity
    of the global token count) on that layer's input."""
    bundle = lm.build_model(cfg, device="cpu")
    model = bundle.load({k: torch.from_numpy(v) for k, v in state.items()})
    seen = []
    real = t_transformer.moe_apply

    def capture(params, x, **kw):
        seen.append((params["router"].detach().numpy(), x.detach().numpy()))
        return real(params, x, **kw)

    t_transformer.moe_apply = capture
    try:
        with torch.no_grad():
            bundle.loss(model, batch)
    finally:
        t_transformer.moe_apply = real
    out = []
    for router, x in seen:
        tokens = jnp.asarray(x.reshape(-1, x.shape[-1]))
        T, n_experts = tokens.shape[0], router.shape[1]
        C = r_capacity_of(T, cfg.top_k, n_experts, cfg.capacity_factor)
        _, top_i = jax.lax.top_k(tokens.astype(jnp.float32) @ jnp.asarray(router), cfg.top_k)
        flat_e = top_i.reshape(-1)
        sorted_e = flat_e[jnp.argsort(flat_e, stable=True)]
        pos = jnp.arange(T * cfg.top_k) - jnp.searchsorted(sorted_e, jnp.arange(n_experts), side="left")[sorted_e]
        out.append((int(jnp.sum(pos < C)), T * cfg.top_k))
    return out


def _serve_inputs(cfg, seed=3):
    toks = lm.tokens(cfg, b=BATCH, s=PROMPT + NEW, seed=seed)
    return toks, lm.stubs(cfg, BATCH, seed), PROMPT, lm.vision(cfg) + PROMPT + NEW + 1


def _one_device_serve(cfg, state, serve):
    toks, stubs, prompt, max_len = serve
    bundle = lm.build_model(cfg, device="cpu")
    model = bundle.load({k: torch.from_numpy(v) for k, v in state.items()})
    cache = bundle.init_cache(BATCH, max_len)
    logits, cache = bundle.prefill(model, {"tokens": toks[:, :prompt], **stubs}, cache)
    seq = [logits.numpy()]
    for t in range(prompt, toks.shape[1]):
        logits, cache = bundle.decode(model, toks[:, t : t + 1], cache)
        seq.append(logits.numpy())
    return seq


def _grads(cfg, state, batch):
    bundle = lm.build_model(cfg, device="cpu")
    model = bundle.load({k: torch.from_numpy(v) for k, v in state.items()})
    named = dict(model.named_parameters())
    loss = bundle.loss(model, batch)
    return {k: g.numpy() for k, g in zip(named, torch.autograd.grad(loss, list(named.values())))}


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("tp")
    cases, train, want = [], [], {}
    for label, arch, overrides in CASES:
        _, cfg = lm.configs(arch, **overrides)
        state = _state(cfg)
        batches = [_batch(cfg, 1), _batch(cfg, 2)]
        serve = _serve_inputs(cfg)
        cases.append((label, arch, overrides, state, batches, serve))
        train.append((label, arch, overrides, state, batches))
    compress = []
    for label, arch, _ in CASES:
        if label in COMPRESS_LABELS:
            _, cfg = lm.configs(arch)
            grads = _grads(cfg, _state(cfg), _batch(cfg, 1))
            compress.append((label, arch, grads, COMPRESS))
    checkpoint = {"meshes": CHECKPOINT_MESHES, "dir": str(base / "ckpt"), "steps": 2, "arch": "qwen2-0.5b"}
    join = ranks.start_worlds("tp", list(MESHES), base / "ranks", timeout=400.0,
                              inputs={"cases": cases, "meshes": MESHES, "compress": compress,
                                      "checkpoint": checkpoint})

    # while the ranks run: the reference's steps (compiled in threads: XLA
    # compiles without the interpreter lock), the one-device serving and
    # compression, the reference's routing
    with ThreadPoolExecutor(4) as pool:
        refs = dict(zip(LABELS, pool.map(_reference, train)))
    for label, arch, overrides, state, batches, serve in cases:
        cfg = lm.configs(arch, **overrides)[1]
        want[label] = {**refs[label], "serve": _one_device_serve(cfg, state, serve)}
        if cfg.family == "moe":
            want[label]["routed"] = _reference_routing(cfg, state, batches[0])
    for label, arch, grads, kw in compress:
        _, cfg = lm.configs(arch)
        ref_tree = convert.lm_params_to_reference({k: torch.from_numpy(v) for k, v in grads.items()}, cfg)
        out = compress_gradients(ref_tree, engine=CorrectionEngine(device="cpu", fft_impl="pallas"), **kw)
        want[("compress", label)] = {"single": {k: v.numpy() for k, v in
                                                convert.lm_params_from_reference(out, cfg).items()},
                                     "grads": grads}
    return {"ranks": join(), "want": want}


def _ranks(runs, shape):
    got = runs["ranks"][_world(shape)]
    if isinstance(got, str):
        pytest.fail(f"world size {_world(shape)}: {got}")
    return got


def _case(runs, key):
    return [r[key] for r in _ranks(runs, key[0])]


@pytest.mark.parametrize("key", KEYS, ids=_id)
def test_losses_are_the_references(tp_runs, key):
    got = _case(tp_runs, key)
    want = tp_runs["want"][key[1]]["losses"]
    for r in got:
        assert r["losses"] == got[0]["losses"], "ranks report different losses"
    np.testing.assert_allclose(got[0]["losses"], want, rtol=1e-5)


@pytest.mark.parametrize("key", KEYS, ids=_id)
def test_parameters_after_two_steps_are_the_references(tp_runs, key):
    got = _case(tp_runs, key)
    want = tp_runs["want"][key[1]]["params"]
    assert all(r["params"] is None for r in got[1:])  # gathered to rank 0
    params = got[0]["params"]
    assert set(params) == set(want)
    for k, w in want.items():
        atol = 1e-4 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(params[k], w, rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("key", KEYS, ids=_id)
def test_gradients_are_the_references(tp_runs, key):
    """The reduced gradient blocks, gathered: summed over "model" where each
    rank computed its own part, kept without a sum where every rank computed
    the whole (a sum would be 2 or 4 times the gradient)."""
    got = _case(tp_runs, key)[0]["grads"]
    want = tp_runs["want"][key[1]]["grads"]
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()), err_msg=k)


@pytest.mark.parametrize("key", KEYS, ids=_id)
def test_each_rank_holds_the_rules_share(tp_runs, key):
    got = _case(tp_runs, key)
    for r in got:
        assert r["state_bytes"] == r["share_bytes"], (r["data_rank"], r["model_rank"])
    # the (data, model) coordinates: data-major
    nd, nm = key[0]
    assert [(r["data_rank"], r["model_rank"]) for r in got] == [(d, m) for d in range(nd) for m in range(nm)]
    one = sum(np.asarray(v).nbytes for v in tp_runs["want"][key[1]]["params"].values())
    assert got[0]["share_bytes"] < 3 * one  # params and two float32 moments, split


@pytest.mark.parametrize("key", KEYS, ids=_id)
def test_global_norm_counts_every_element_once(tp_runs, key):
    got = _case(tp_runs, key)
    grads = got[0]["grads"]
    want = np.sqrt(sum(float(np.sum(np.square(g.astype(np.float64)))) for g in grads.values()))
    for r in got:
        np.testing.assert_allclose(r["norm"], want, rtol=1e-6)


@pytest.mark.parametrize("key", KEYS, ids=_id)
def test_prefill_and_decode_over_the_model_axis(tp_runs, key):
    """Logits gathered over rows (the data ranks) and vocab (the model
    ranks: each returns its block) against the one-device bundle's."""
    got = _case(tp_runs, key)
    want = tp_runs["want"][key[1]]["serve"]
    nd, nm = key[0]
    for step, w in enumerate(want):
        rows = []
        for d in range(nd):
            blocks = [got[d * nm + m]["serve"]["logits"][step] for m in range(nm)]
            assert all(b.shape[-1] == w.shape[-1] // nm for b in blocks)
            rows.append((got[d * nm]["serve"]["rows"], np.concatenate(blocks, axis=-1)))
        full = np.zeros_like(w)
        for sl, part in rows:
            full[sl] = part
        np.testing.assert_allclose(full, w, rtol=0, atol=1e-5 * float(np.abs(w).max()), err_msg=f"step {step}")


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
def test_moe_routed_pairs_and_drops_are_the_references(tp_runs, shape):
    got = _case(tp_runs, (shape, "moe"))
    want = tp_runs["want"]["moe"]["routed"]
    assert any(kept < pairs for kept, pairs in want)  # the capacity drops pairs
    for m in range(shape[1]):
        per_rank = [r["routed"] for r in got if r["model_rank"] == m]
        summed = [(sum(r[i][0] for r in per_rank), sum(r[i][1] for r in per_rank)) for i in range(len(want))]
        assert summed == want, m


@pytest.mark.parametrize("key", COMPRESS_KEYS, ids=_id)
def test_compression_is_bitwise_the_one_device_call(tp_runs, key):
    got = _ranks(tp_runs, key[0])[0][(key[0], "compress", key[1])]
    want = tp_runs["want"][("compress", key[1])]
    for k, w in want["single"].items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert any(not np.array_equal(want["single"][k], want["grads"][k]) for k in want["grads"])


@pytest.mark.parametrize("key", [((1, 2), "dense"), ((1, 4), "dense"), ((2, 2), "audio"), ((1, 2), "ssm")], ids=_id)
def test_each_tensor_is_read_as_its_split_allows(tp_runs, key):
    """Heads split at a model size of 2 (``wqkv`` gathered over "model" and
    the rank's q, k and v heads taken, its gradient summed; ``wo`` read as
    stored); at 4 they do not (the replicated branch, logged: ``wqkv`` and
    ``wo`` read whole, each rank keeping its block of the gradient with no
    sum); Mamba2 is replicated compute over gathered weights; whisper's
    unsplit ``w_up`` is column-parallel."""
    r = _case(tp_runs, key)[0]
    uses, ctx = r["uses"], r["ctx"]
    notes = _ranks(tp_runs, key[0])[0]["replicated_notes"]
    if key[1] == "dense":
        heads = key[0][1] == 2
        assert ctx["heads"] is heads and ctx["mlp"] and ctx["vocab"]
        assert uses["layers.0.attn.wqkv"] == ((True, True, "sum") if heads else (True, False, "own"))
        assert uses["layers.0.attn.wo"] == ((False, False, "local") if heads else (True, False, "own"))
        assert uses["layers.0.mlp.w_gu"] == uses["layers.0.mlp.w_down"] == uses["embed"] == (False, False, "local")
        assert uses["layers.0.ln_attn.scale"] == (False, False, "local")
        replicated = [n for n in notes if "over a 'model' axis of 4" in n]
        assert len(replicated) == (0 if heads else 1), notes  # logged once a configuration
    elif key[1] == "ssm":
        assert uses["layers.0.in_proj"] == uses["layers.0.out_proj"] == uses["layers.0.conv_w"] == (True, False, "own")
        assert uses["layers.0.A_log"] == (False, False, "local")
    else:
        assert uses["decoder.0.mlp.w_up"] == (False, True, "sum")
        assert uses["decoder.0.mlp.w_down"] == (False, False, "local")
        assert uses["decoder.0.cross_attn.wqkv"] == (True, True, "sum")


@pytest.mark.parametrize("shape", CHECKPOINT_MESHES, ids=str)
def test_a_checkpoint_restores_over_the_model_axis(tp_runs, shape):
    got = _case(tp_runs, (shape, "checkpoint"))
    saved, restored = got[0]["saved"], got[0]["restored"]
    assert got[0]["start"] == 2 and len(saved) == len(restored)
    for a, b in zip(restored, saved):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert all(r["saved"] is None and r["restored"] is None for r in got[1:])
    assert [r["decoded_leaves"] > 0 for r in got] == [True] + [False] * (len(got) - 1)
    assert all(r["held"] == r["share"] for r in got)
    assert len({r["loss"] for r in got}) == 1 and np.isfinite(got[0]["loss"])
