"""The port's training path against the reference's: train step, Trainer,
token pipeline, train entry point, and checkpoints crossing between them.

Tolerances (float32 smoke config):
  * the loss of one step: rtol 1e-6; its gradients: within 1e-5 of each
    leaf's largest |gradient| (torch's and XLA's CPU matmuls and reductions
    sum in other orders), for every ``remat`` mode;
  * across ``remat`` modes in the port: loss and gradients bitwise (the
    recomputation runs the same operations);
  * a Trainer run from the same parameters on the same batches: per-step
    losses rtol 1e-5 (measured 3.5e-7 over 5 steps) and parameters within
    1e-4 of the reference's (Adam divides by the gradients' root mean
    square, so an element whose tiny gradient changes sign moves by 2 lr);
  * the reference's ``tests/test_trainer.py`` fault-tolerance checks on the
    port, with the reference test's rtol 1e-4 for a deterministic restart.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.checkpoint.manager import CheckpointManager as RManager
from repro.configs import CompressionConfig as RCompressionConfig
from repro.configs import get_smoke_config as r_get_smoke_config
from repro.data.pipeline import TokenPipeline as RTokenPipeline
from repro.models import model as r_model
from repro.runtime.trainer import Trainer as RTrainer
from repro.runtime.trainer import TrainerConfig as RTrainerConfig
from repro_torch import convert, tree
from repro_torch.configs import CompressionConfig, get_smoke_config
from repro_torch.data import TokenPipeline
from repro_torch.data.pipeline import pipeline_for
from repro_torch.launch import steps, train
from repro_torch.models import model as t_model
from repro_torch.runtime import SimulatedFailure, Trainer, TrainerConfig

ARCH = "qwen2-0.5b"


def _ref_params(cfg, seed=0):
    return jax.tree.map(np.asarray, r_model.build_model(cfg).init(jax.random.PRNGKey(seed)))


def _tokens(cfg, b=4, s=32, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _grads(cfg, params, tokens):
    bundle = t_model.build_model(cfg, device="cpu")
    model = bundle.load(convert.lm_params_from_reference(params, cfg))
    named = dict(model.named_parameters())
    loss = bundle.loss(model, {"tokens": tokens})
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    return float(loss.detach()), convert.lm_params_to_reference(grads, cfg)


# ---------------------------------------------------------------------------
# the loss that trains


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_loss_and_gradients_match_reference(remat):
    rcfg, cfg = r_get_smoke_config(ARCH, remat=remat), get_smoke_config(ARCH, remat=remat)
    params, tokens = _ref_params(rcfg), _tokens(cfg)
    r_loss, r_grads = jax.value_and_grad(r_model.build_model(rcfg).loss)(params, {"tokens": jnp.asarray(tokens)})
    loss, grads = _grads(cfg, params, tokens)
    np.testing.assert_allclose(loss, float(r_loss), rtol=1e-6)
    want, want_def = jax.tree.flatten(jax.tree.map(np.asarray, r_grads))
    got, got_def = jax.tree.flatten(jax.tree.map(lambda t: t.numpy(), grads))
    assert want_def == got_def
    for w, g in zip(want, got):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


class _CountOps(TorchDispatchMode):
    """Counts the matrix products and the SiLUs executed (the SwiGLU's
    activation: one per block forward, none in the backward)."""

    def __init__(self):
        super().__init__()
        self.mm = self.silu = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default)
        self.silu += func is torch.ops.aten.silu.default
        return func(*args, **(kwargs or {}))


def test_remat_modes_trade_saved_activations_for_recomputation():
    """``full`` recomputes every forward operation of a block in the
    backward, ``dots`` all but the matrix products (their saved outputs are
    reused), ``none`` nothing; the results are bitwise the same."""
    cfg = get_smoke_config(ARCH)
    params, tokens = _ref_params(r_get_smoke_config(ARCH)), _tokens(cfg, s=64)
    out = {}
    for m in ("none", "dots", "full"):
        with _CountOps() as count:
            loss, grads = _grads(dataclasses.replace(cfg, remat=m), params, tokens)
        out[m] = (loss, grads, count.mm, count.silu)
    assert out["none"][2] == out["dots"][2] < out["full"][2]
    assert out["none"][3] == cfg.n_layers and out["dots"][3] == out["full"][3] == 2 * cfg.n_layers
    for m in ("dots", "full"):
        assert out[m][0] == out["none"][0]
        for a, b in zip(tree.leaves(out[m][1]), tree.leaves(out["none"][1])):
            assert torch.equal(a, b)


def test_scoring_without_grad_builds_no_graph():
    cfg = get_smoke_config(ARCH)
    bundle = t_model.build_model(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    assert bundle.loss(params, {"tokens": _tokens(cfg)}).requires_grad
    with torch.no_grad():
        assert not bundle.loss(params, {"tokens": _tokens(cfg)}).requires_grad


def test_unknown_remat_raises():
    cfg = get_smoke_config(ARCH, remat="sometimes")
    bundle = t_model.build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="remat"):
        bundle.loss(bundle.init(torch.Generator().manual_seed(0)), {"tokens": _tokens(cfg)})


# ---------------------------------------------------------------------------
# Trainer against the reference's


def _run(td, **kw):
    base = dict(seq_len=32, global_batch=4, ckpt_dir=str(td), ckpt_every=5, ckpt_async=False, log_every=5)
    base.update(kw)
    return base


class _ReferenceBatches:
    def __init__(self, pipeline):
        self.pipeline = pipeline

    def batch_at(self, step):
        return {"tokens": np.array(self.pipeline.batch_at(step)["tokens"])}


@pytest.mark.parametrize("grad_compression", [False, True], ids=["plain", "grad_compression"])
def test_trainer_matches_reference(tmp_path, grad_compression):
    """Three steps from the reference's initial parameters on its batches."""
    kw = dict(grad_compression=grad_compression, grad_block=512)
    rcfg = dataclasses.replace(r_get_smoke_config(ARCH), compression=RCompressionConfig(**kw))
    cfg = dataclasses.replace(get_smoke_config(ARCH), compression=CompressionConfig(**kw))
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
            # weights and norms are O(1); the biases start at 0 and move by
            # Adam's update, which for a near-zero gradient turns on its sign
            atol = 1e-4 * max(1.0, float(np.abs(a).max()))
        else:
            # the moments m ~ g and v ~ g^2 sit far below 1: scaled per leaf
            atol = 1e-3 * float(np.abs(a).max())
        np.testing.assert_allclose(b, a, rtol=0, atol=atol)


def test_checkpoints_cross_between_the_trainers(tmp_path):
    """A port Trainer's checkpoint restores in the reference's Trainer (same
    leaves, bitwise), and the reference's in the port's."""
    cfg, rcfg = get_smoke_config(ARCH), r_get_smoke_config(ARCH)
    tt = Trainer(cfg, TrainerConfig(**_run(tmp_path / "p", ckpt_every=2)), device="cpu")
    tt.train(2)
    rt = RTrainer(rcfg, RTrainerConfig(**_run(tmp_path / "p", ckpt_every=2)))
    assert rt.start_step == 2
    for a, b in zip(jax.tree.leaves((rt.params, rt.opt_state)), tree.leaves(tt.state())):
        assert np.array_equal(np.asarray(a), b.numpy())
    rt.train(2)  # the reference trains on from the port's state and saves step 4
    tt2 = Trainer(cfg, TrainerConfig(**_run(tmp_path / "p", ckpt_every=2)), device="cpu")
    assert tt2.start_step == 4
    for a, b in zip(jax.tree.leaves((rt.params, rt.opt_state)), tree.leaves(tt2.state())):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert int(tt2.opt_state["step"]) == 4
    tt2.train(1)


def test_trainer_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(get_smoke_config(ARCH), TrainerConfig(**_run(tmp_path)))


def test_trainer_takes_no_mesh(tmp_path):
    with pytest.raises(NotImplementedError, match="DeviceMesh"):
        Trainer(get_smoke_config(ARCH), TrainerConfig(**_run(tmp_path)), mesh=object(), device="cpu")


def test_trainer_config_fields_are_the_references():
    ours = [f.name for f in dataclasses.fields(TrainerConfig)]
    theirs = [f.name for f in dataclasses.fields(RTrainerConfig)]
    assert ours == theirs


# ---------------------------------------------------------------------------
# the reference's tests/test_trainer.py fault-tolerance checks, on the port


class TestFaultTolerance:
    def test_failure_then_restart_resumes(self, tmp_path):
        cfg = get_smoke_config(ARCH)
        tr = Trainer(cfg, TrainerConfig(**_run(tmp_path, inject_failure_at=7)), device="cpu")
        with pytest.raises(SimulatedFailure):
            tr.train(20)
        tr2 = Trainer(cfg, TrainerConfig(**_run(tmp_path)), device="cpu")
        assert tr2.start_step == 5  # last committed checkpoint
        out = tr2.train(5)
        assert out["final_step"] == 10

    @pytest.mark.parametrize("ckpt_async", [False, True], ids=["blocking", "async"])
    def test_restart_is_deterministic(self, tmp_path, ckpt_async):
        """Uninterrupted run and crash+resume must produce the same loss
        (counter-mode data pipeline + checkpointed optimizer state)."""
        cfg = get_smoke_config(ARCH)
        tr = Trainer(cfg, TrainerConfig(**_run(tmp_path / "a", ckpt_every=100)), device="cpu")
        ref = tr.train(10)["final_loss"]

        tr1 = Trainer(cfg, TrainerConfig(**_run(tmp_path / "b", ckpt_async=ckpt_async,
                                                inject_failure_at=7)), device="cpu")
        with pytest.raises(SimulatedFailure):
            tr1.train(10)
        tr2 = Trainer(cfg, TrainerConfig(**_run(tmp_path / "b", ckpt_async=ckpt_async)), device="cpu")
        assert tr2.start_step == 5
        out = tr2.train(5)
        np.testing.assert_allclose(out["final_loss"], ref, rtol=1e-4)

    def test_loss_decreases(self, tmp_path):
        cfg = get_smoke_config(ARCH)
        tr = Trainer(cfg, TrainerConfig(**_run(tmp_path, ckpt_every=1000, log_every=1)), device="cpu")
        out = tr.train(30)
        first = out["metrics"][0]["loss"]
        last = out["metrics"][-1]["loss"]
        assert last < first, (first, last)

    def test_grad_compression_still_learns(self, tmp_path):
        comp = CompressionConfig(grad_compression=True, grad_E_rel=1e-2, grad_Delta_rel=1e-1, grad_block=512)
        cfg = dataclasses.replace(get_smoke_config(ARCH), compression=comp)
        tr = Trainer(cfg, TrainerConfig(**_run(tmp_path, ckpt_every=1000, log_every=1)), device="cpu")
        out = tr.train(30)
        assert out["metrics"][-1]["loss"] < out["metrics"][0]["loss"]

    def test_compressed_checkpoints_restore_within_bounds(self, tmp_path):
        comp = CompressionConfig(checkpoint_compression=True, ckpt_E_rel=1e-5, ckpt_Delta_rel=1e-5)
        cfg = dataclasses.replace(get_smoke_config(ARCH, d_model=128, d_ff=256), compression=comp)
        tr = Trainer(cfg, TrainerConfig(**_run(tmp_path, ckpt_every=2)), device="cpu")
        tr.train(2)
        saved = tr.state()
        tr2 = Trainer(cfg, TrainerConfig(**_run(tmp_path, ckpt_every=2)), device="cpu")
        assert tr2.start_step == 2
        tags = {(tmp_path / "step_000000000002" / f"{i}.bin").read_bytes()[:1]
                for i in range(len(tree.leaves(saved)))}
        assert tags == {b"B", b"R"}
        for a, b in zip(tree.leaves(saved), tree.leaves(tr2.state())):
            a, b = a.double(), b.double()
            if a.numel() >= 4096 and float(a.max() - a.min()) > 0 and a.dtype.is_floating_point:
                assert float((a - b).abs().max()) <= 1e-5 * float(a.max() - a.min()) * (1 + 1e-5)
            else:
                assert torch.equal(a, b)
        assert np.isfinite(tr2.train(1)["final_loss"])

    def test_straggler_tracking(self, tmp_path):
        cfg = get_smoke_config(ARCH)
        tr = Trainer(cfg, TrainerConfig(**_run(tmp_path, ckpt_every=1000)), device="cpu")
        tr.step_times = [0.1] * 10
        tr._track_straggler(11, 1.0)  # 10x median
        assert tr.straggler_events and tr.straggler_events[-1]["step"] == 11


# ---------------------------------------------------------------------------
# token pipeline


def test_batches_are_a_pure_function_of_seed_step_and_shard():
    p = TokenPipeline(vocab=256, seq_len=64, global_batch=8, seed=3)
    a, b = p.batch_at(5)["tokens"], p.batch_at(5)["tokens"]
    assert a.shape == (8, 64) and a.dtype == torch.int32 and torch.equal(a, b)
    assert not torch.equal(a, p.batch_at(6)["tokens"])
    assert not torch.equal(a, TokenPipeline(vocab=256, seq_len=64, global_batch=8, seed=4).batch_at(5)["tokens"])
    s0 = TokenPipeline(vocab=256, seq_len=64, global_batch=8, seed=3, n_shards=2, shard=0).batch_at(5)["tokens"]
    s1 = TokenPipeline(vocab=256, seq_len=64, global_batch=8, seed=3, n_shards=2, shard=1).batch_at(5)["tokens"]
    assert s0.shape == (4, 64) and not torch.equal(s0, s1)


def test_token_statistics_are_the_references():
    """Not the reference's stream (torch's generator, not threefry), but its
    distribution: Zipf-like ranks and the Markov copy of p = 0.5."""
    vocab, n = 1000, 40
    ours = np.concatenate([TokenPipeline(vocab, 256, 8).batch_at(s)["tokens"].numpy() for s in range(n)])
    theirs = np.concatenate([np.asarray(RTokenPipeline(vocab, 256, 8).batch_at(s)["tokens"]) for s in range(n)])
    for toks in (ours, theirs):
        assert toks.min() >= 0 and toks.max() < vocab
    copy = lambda t: float(np.mean(t[:, 1:] == t[:, :-1]))  # noqa: E731
    assert abs(copy(ours) - copy(theirs)) < 0.03
    for q in (10, 100):
        assert abs(float(np.mean(ours < q)) - float(np.mean(theirs < q))) < 0.03


def test_pipeline_for_dense_only():
    """A dense config's pipeline carries tokens only; the vlm's and the
    audio's carry the reference's stub keys and shapes (``patches``, with
    ``seq_len - vision_tokens`` tokens; ``frames``)."""
    from repro.data.pipeline import pipeline_for as r_pipeline_for

    cfg = get_smoke_config(ARCH)
    p = pipeline_for(cfg, 16, 2, seed=1)
    assert (p.vocab, p.seq_len, p.global_batch, p.seed) == (cfg.vocab, 16, 2, 1)
    assert set(p.batch_at(0)) == {"tokens"}
    for arch in ("llava-next-mistral-7b", "whisper-tiny"):
        ours = pipeline_for(get_smoke_config(arch), 40, 2).batch_at(0)
        theirs = r_pipeline_for(r_get_smoke_config(arch), 40, 2).batch_at(0)
        assert {k: tuple(v.shape) for k, v in ours.items()} == {k: v.shape for k, v in theirs.items()}
        assert {k: str(v.dtype).split(".")[-1] for k, v in ours.items()} == {k: str(v.dtype) for k, v in theirs.items()}
    b = TokenPipeline(vocab=10, seq_len=4, global_batch=2, audio_frames=3, audio_dim=5).batch_at(0)
    assert b["frames"].shape == (2, 3, 5)


def test_pipeline_fields_are_the_references():
    assert [f.name for f in dataclasses.fields(TokenPipeline)] == [f.name for f in dataclasses.fields(RTokenPipeline)]


# ---------------------------------------------------------------------------
# step functions and the entry point


def test_prefill_and_serve_steps_are_the_bundles():
    cfg = get_smoke_config(ARCH)
    bundle = t_model.build_model(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    toks = _tokens(cfg, b=2, s=8)
    logits, cache = steps.make_prefill_step(bundle)(params, {"tokens": toks}, bundle.init_cache(2, 10))
    want, _ = bundle.prefill(params, {"tokens": toks}, bundle.init_cache(2, 10))
    assert torch.equal(logits, want)
    out, cache = steps.make_serve_step(bundle)(params, toks[:, -1:], cache)
    assert out.shape == (2, 1, cfg.vocab_padded) and cache["pos"] == 9
    with pytest.raises(NotImplementedError, match="DeviceMesh"):
        steps.make_step(cfg, "train", mesh=None)


def test_train_entry_point(tmp_path, capsys):
    train.main(["--arch", ARCH, "--steps", "3", "--seq-len", "16", "--global-batch", "2",
                "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--device", "cpu"])
    assert "done: step=3" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_000000000002", "step_000000000003"]
    step, _ = RManager(str(tmp_path)).restore_latest(jax.eval_shape(
        lambda k: (r_model.build_model(r_get_smoke_config(ARCH)).init(k),
                   {"m": r_model.build_model(r_get_smoke_config(ARCH)).init(k),
                    "v": r_model.build_model(r_get_smoke_config(ARCH)).init(k),
                    "step": jnp.int32(0)}),
        jax.random.PRNGKey(0)))
    assert step == 3
