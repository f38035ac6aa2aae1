"""Training the moe, ssm, hybrid, vlm and audio families: the port against
the reference, at each arch's SMOKE config (float32).

Every test is parametrised over the five archs (granite-moe-3b-a800m,
mamba2-2.7b, zamba2-7b, llava-next-mistral-7b, whisper-tiny); both packages
get the reference's parameters and the same numpy batches (tokens, and the
vlm's ``patches`` or the audio's ``frames``).  Tolerances, as the dense
slice's (``test_torch_trainer.py``):
  * the loss of one step: rtol 1e-6; its gradients: within 1e-5 of each
    leaf's largest |gradient|, for every ``remat`` mode (torch's and XLA's
    CPU products and reductions sum in other orders);
  * a 3-step Trainer run from the same parameters on the same batches, with
    and without FFCz gradient compression (the dense test's settings, block
    512): per-step losses rtol 1e-5; parameters within 1e-4 of the
    reference's (scaled by the leaf's magnitude when above 1), moments
    within 1e-3 of the leaf's largest |moment|.  Where the correction acts
    (``grad_Delta_rel = 5e-5``) the two packages' float32 FFTs differ in the
    last bits, so the corrected gradients agree within 1e-6 of each leaf's
    largest |gradient| (``test_gradient_pencils_per_family``); Adam divides
    by the gradient's root mean square, so such a difference on a near-zero
    element moves a parameter by up to 2 lr, and the Trainer comparison
    keeps the correction idle as the dense test does;
  * checkpoints crossing between the two Trainers, and the gradients' and
    moments' round trip through the reference's tree layout: bitwise;
  * the fault-tolerance checks of the reference's ``tests/test_trainer.py``
    with that test's rtol 1e-4 for a deterministic restart;
  * the MoE with pairs dropped at capacity: the input and parameter
    gradients within 1e-5 of each leaf's largest |gradient| of the
    reference's ``.at[].add(mode="drop")``, and a token whose every pair
    is dropped gets a gradient of exactly zero (random inputs: no router
    ties).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm_parity as lm
from repro.configs import CompressionConfig as RCompressionConfig
from repro.models import model as r_model
from repro.models import moe as r_moe
from repro.runtime.trainer import Trainer as RTrainer
from repro.runtime.trainer import TrainerConfig as RTrainerConfig
from repro_torch import convert, tree
from repro_torch.configs import CompressionConfig, get_config, get_smoke_config
from repro_torch.data.pipeline import pipeline_for
from repro_torch.launch import steps, train
from repro_torch.models import moe as t_moe
from repro_torch.optim import compress_gradients
from repro_torch.runtime import SimulatedFailure, Trainer, TrainerConfig

ARCHS = ["granite-moe-3b-a800m", "mamba2-2.7b", "zamba2-7b", "llava-next-mistral-7b", "whisper-tiny"]
#: a vlm's seq_len counts its vision positions: SMOKE llava's 16 leave 16 tokens
SEQ_LEN = 32


def _grads(cfg, params_np, b):
    bundle, model = lm.port_model(cfg, params_np)
    named = dict(model.named_parameters())
    loss = bundle.loss(model, b)
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    return float(loss.detach()), grads


def _assert_leaves_close(got, want, rel):
    want_l, want_def = jax.tree.flatten(jax.tree.map(np.asarray, want))
    got_l, got_def = jax.tree.flatten(jax.tree.map(lambda t: t.detach().numpy(), got))
    assert want_def == got_def
    for w, g in zip(want_l, got_l):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * np.abs(w).max())


# ---------------------------------------------------------------------------
# the loss that trains


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch, remat):
    rcfg, cfg = lm.configs(arch, remat=remat)
    params = lm.ref_params(rcfg)
    b = lm.batch(cfg, lm.tokens(cfg, b=2, s=24))
    r_loss, r_grads = jax.value_and_grad(r_model.build_model(rcfg).loss)(params, lm.jnp_batch(b))
    loss, grads = _grads(cfg, params, b)
    np.testing.assert_allclose(loss, float(r_loss), rtol=1e-6)
    _assert_leaves_close(convert.lm_params_to_reference(grads, cfg), r_grads, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_and_moments_round_trip_the_reference_layout(arch):
    """Gradients and AdamW's state go to the reference's tree (stacked
    subtrees, zamba2's unstacked ``shared``) and back bitwise."""
    rcfg, cfg = lm.configs(arch)
    _, grads = _grads(cfg, lm.ref_params(rcfg), lm.batch(cfg, lm.tokens(cfg, b=2, s=24)))
    ref = convert.lm_params_to_reference(grads, cfg)
    assert jax.tree.structure(ref) == jax.tree.structure(r_model.build_model(rcfg).init(jax.random.PRNGKey(0)))
    back = convert.lm_params_from_reference(ref, cfg)
    assert list(back) == list(grads) and all(torch.equal(back[k], grads[k]) for k in grads)
    opt = steps.AdamW()
    state = opt.init({k: torch.zeros_like(g) for k, g in grads.items()})
    _, state = opt.update(grads, state, {k: torch.ones_like(g) for k, g in grads.items()})
    again = convert.opt_state_from_reference(convert.opt_state_to_reference(state, cfg), cfg)
    for name in ("m", "v"):
        assert all(torch.equal(again[name][k], state[name][k]) for k in grads)
    assert torch.equal(again["step"], state["step"])


@pytest.mark.parametrize("arch", ARCHS)
def test_gradient_pencils_per_family(arch):
    """``compress_gradients`` on the family's gradient tree: one
    ``engine.correct`` call per effective pencil length, a tensor smaller
    than the block keeping its own (odd) length, every corrected leaf within
    its bound, and the result within rounding of the reference's."""
    from repro.optim.grad_compress import compress_gradients as r_compress

    rcfg, cfg = lm.configs(arch)
    _, grads = _grads(cfg, lm.ref_params(rcfg), lm.batch(cfg, lm.tokens(cfg, b=2, s=24)))
    ref_tree = convert.lm_params_to_reference(grads, cfg)
    kw = dict(bits=8, E_rel=1e-2, Delta_rel=5e-5, block=512)
    from repro_torch.core.engine import CorrectionEngine

    calls = []

    class Recording(CorrectionEngine):
        def correct(self, tensors, E, Delta, block=4096, **k):
            calls.append((block, [t.numel() for t in tensors]))
            return super().correct(tensors, E, Delta, block=block, **k)

    out = compress_gradients(ref_tree, engine=Recording(device="cpu", fft_impl="pallas"), **kw)
    sizes = [g.numel() for g in tree.leaves(ref_tree) if g.numel() >= 2]
    assert sorted(b for b, _ in calls) == sorted({min(512, n) for n in sizes})
    for blk, numels in calls:
        assert all(min(512, n) == blk for n in numels)
    want = r_compress(jax.tree.map(lambda t: jnp.asarray(t.numpy()), ref_tree), **kw)
    for g, o, w in zip(tree.leaves(ref_tree), tree.leaves(out), jax.tree.leaves(want)):
        scale = max(float(g.abs().max()), 1e-30)
        assert float((o - g).abs().max()) <= 1e-2 * scale * (1 + 1e-5)
        np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=0, atol=1e-6 * scale)


# ---------------------------------------------------------------------------
# Trainer against the reference's


def _run(td, **kw):
    base = dict(seq_len=SEQ_LEN, global_batch=4, ckpt_dir=str(td), ckpt_every=5, ckpt_async=False, log_every=5)
    base.update(kw)
    return base


class _ReferenceBatches:
    def __init__(self, pipeline):
        self.pipeline = pipeline

    def batch_at(self, step):
        return {k: np.array(v) for k, v in self.pipeline.batch_at(step).items()}


@pytest.mark.parametrize("grad_compression", [False, True], ids=["plain", "grad_compression"])
@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_matches_reference(tmp_path, arch, grad_compression):
    """Three steps from the reference's initial parameters on its batches."""
    kw = dict(grad_compression=grad_compression, grad_block=512)
    rcfg = dataclasses.replace(lm.configs(arch)[0], compression=RCompressionConfig(**kw))
    cfg = dataclasses.replace(get_smoke_config(arch), compression=CompressionConfig(**kw))
    rt = RTrainer(rcfg, RTrainerConfig(**_run(tmp_path / "r", ckpt_every=100, log_every=1)))
    tt = Trainer(cfg, TrainerConfig(**_run(tmp_path / "t", ckpt_every=100, log_every=1)), device="cpu")
    tt.params = tt.bundle.load(convert.lm_params_from_reference(jax.tree.map(np.asarray, rt.params), cfg))
    tt.opt_state = tt.optimizer.init(tt.params.state_dict())
    tt.pipeline = _ReferenceBatches(rt.pipeline)
    want, got = rt.train(3), tt.train(3)
    assert [m["step"] for m in got["metrics"]] == [m["step"] for m in want["metrics"]] == [1, 2, 3]
    np.testing.assert_allclose([m["loss"] for m in got["metrics"]], [m["loss"] for m in want["metrics"]],
                               rtol=1e-5)
    r_state = jax.tree.map(np.asarray, (rt.params, rt.opt_state))
    t_state = tree.map_leaves(lambda t: t.numpy(), tt.state())
    assert jax.tree.structure(r_state) == jax.tree.structure(t_state)
    n_params = len(jax.tree.leaves(r_state[0]))
    for i, (a, b) in enumerate(zip(jax.tree.leaves(r_state), jax.tree.leaves(t_state))):
        assert a.shape == b.shape and a.dtype == b.dtype
        if i < n_params:
            atol = 1e-4 * max(1.0, float(np.abs(a).max()))
        else:
            atol = 1e-3 * float(np.abs(a).max())
        np.testing.assert_allclose(b, a, rtol=0, atol=atol)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_between_the_trainers(tmp_path, arch):
    """A port Trainer's checkpoint restores in the reference's Trainer (same
    leaves, bitwise), and the reference's in the port's."""
    rcfg, cfg = lm.configs(arch)
    tt = Trainer(cfg, TrainerConfig(**_run(tmp_path / "p", ckpt_every=2)), device="cpu")
    tt.train(2)
    rt = RTrainer(rcfg, RTrainerConfig(**_run(tmp_path / "p", ckpt_every=2)))
    assert rt.start_step == 2
    for a, b in zip(jax.tree.leaves((rt.params, rt.opt_state)), tree.leaves(tt.state())):
        assert np.array_equal(np.asarray(a), b.numpy())
    rt.train(2)
    tt2 = Trainer(cfg, TrainerConfig(**_run(tmp_path / "p", ckpt_every=2)), device="cpu")
    assert tt2.start_step == 4
    for a, b in zip(jax.tree.leaves((rt.params, rt.opt_state)), tree.leaves(tt2.state())):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert np.isfinite(tt2.train(1)["final_loss"])


# ---------------------------------------------------------------------------
# the reference's tests/test_trainer.py fault-tolerance checks, per family


@pytest.mark.parametrize("arch", ARCHS)
def test_failure_then_restart_resumes(tmp_path, arch):
    cfg = get_smoke_config(arch)
    tr = Trainer(cfg, TrainerConfig(**_run(tmp_path, inject_failure_at=7)), device="cpu")
    with pytest.raises(SimulatedFailure):
        tr.train(20)
    tr2 = Trainer(cfg, TrainerConfig(**_run(tmp_path)), device="cpu")
    assert tr2.start_step == 5  # last committed checkpoint
    assert tr2.train(5)["final_step"] == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_restart_is_deterministic(tmp_path, arch):
    """Uninterrupted run and crash + resume give the same loss, with
    compressed gradients and an asynchronous checkpoint."""
    comp = CompressionConfig(grad_compression=True, grad_block=512, grad_Delta_rel=5e-5)
    cfg = dataclasses.replace(get_smoke_config(arch), compression=comp)
    ref = Trainer(cfg, TrainerConfig(**_run(tmp_path / "a", ckpt_every=100)), device="cpu").train(4)["final_loss"]
    tr1 = Trainer(cfg, TrainerConfig(**_run(tmp_path / "b", ckpt_every=2, ckpt_async=True, inject_failure_at=2)),
                  device="cpu")
    with pytest.raises(SimulatedFailure):
        tr1.train(4)
    tr2 = Trainer(cfg, TrainerConfig(**_run(tmp_path / "b", ckpt_every=2)), device="cpu")
    assert tr2.start_step == 2
    out = tr2.train(2)
    assert np.isfinite(ref)
    np.testing.assert_allclose(out["final_loss"], ref, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_decreases(tmp_path, arch):
    cfg = get_smoke_config(arch)
    tr = Trainer(cfg, TrainerConfig(**_run(tmp_path, ckpt_every=1000, log_every=1)), device="cpu")
    out = tr.train(12)
    assert out["metrics"][-1]["loss"] < out["metrics"][0]["loss"]


# ---------------------------------------------------------------------------
# family specifics


def test_moe_dropped_pairs_get_zero_gradient():
    """At a capacity that drops pairs, the port's dispatch/combine gradients
    are the reference's, and a token whose every choice is dropped (no
    shared expert) gets exactly zero gradient through the MoE."""
    d, f, n_e, k, T = 16, 24, 4, 2, 48
    rng = np.random.default_rng(7)
    p_np = jax.tree.map(np.asarray, r_moe.moe_init(jax.random.PRNGKey(3), d, f, n_e, False, jnp.float32))
    x_np = rng.standard_normal((1, T, d)).astype(np.float32)
    cap = 0.5
    routing = t_moe.route(torch.from_numpy(p_np["router"].copy()), torch.from_numpy(x_np[0]), top_k=k,
                          capacity_factor=cap, e_pad=n_e)
    kept = torch.zeros(T, dtype=torch.int64).index_add(0, routing.sorted_t, routing.keep.to(torch.int64))
    assert int((~routing.keep).sum()) > 0 and int((kept == 0).sum()) > 0

    def r_loss(p, x):
        out = r_moe.moe_apply(p, x, top_k=k, capacity_factor=cap)
        return jnp.sum(out * jnp.asarray(np.linspace(-1, 1, d, dtype=np.float32)))

    r_gp, r_gx = jax.grad(r_loss, argnums=(0, 1))(jax.tree.map(jnp.asarray, p_np), jnp.asarray(x_np))
    p = {n: torch.from_numpy(v.copy()).requires_grad_() for n, v in p_np.items()}
    x = torch.from_numpy(x_np.copy()).requires_grad_()
    out = t_moe.moe_apply(p, x, top_k=k, capacity_factor=cap)
    gx, *gp = torch.autograd.grad(torch.sum(out * torch.linspace(-1, 1, d)), [x, *p.values()])
    _assert_leaves_close({"x": gx, **dict(zip(p, gp))}, {"x": r_gx, **r_gp}, 1e-5)
    dropped = (kept == 0).nonzero().reshape(-1)
    assert torch.count_nonzero(gx[0, dropped]) == 0
    assert torch.count_nonzero(gx[0, kept > 0]) > 0


@pytest.mark.parametrize("seq_len", [8, 16], ids=["below", "equal"])
def test_vlm_seq_len_must_exceed_its_vision_tokens(tmp_path, seq_len):
    cfg = get_smoke_config("llava-next-mistral-7b")
    assert cfg.vision_tokens == 16
    with pytest.raises(ValueError, match="vision"):
        pipeline_for(cfg, seq_len, 2)
    with pytest.raises(ValueError, match="vision"):
        Trainer(cfg, TrainerConfig(**_run(tmp_path, seq_len=seq_len)), device="cpu")
    with pytest.raises(ValueError, match="vision"):
        pipeline_for(get_config("llava-next-mistral-7b"), 2880, 2)
    assert pipeline_for(cfg, 17, 2).batch_at(0)["tokens"].shape == (2, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_entry_point(tmp_path, capsys, arch):
    train.main(["--arch", arch, "--steps", "2", "--seq-len", str(SEQ_LEN), "--global-batch", "2",
                "--ckpt-dir", str(tmp_path), "--ckpt-every", "1", "--grad-compression", "--device", "cpu"])
    assert "done: step=2" in capsys.readouterr().out
    train.main(["--arch", arch, "--steps", "1", "--seq-len", str(SEQ_LEN), "--global-batch", "2",
                "--ckpt-dir", str(tmp_path), "--n-layers", str(get_smoke_config(arch).n_layers), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "restored checkpoint at step 2" in out and "done: step=3" in out
