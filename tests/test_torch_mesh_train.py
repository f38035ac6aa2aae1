"""Training over a data mesh on gloo ranks (world sizes 1, 2 and 4).

One module-scoped fixture builds the inputs here (the port's initial
parameters, which the reference gets through ``convert``; numpy batches;
the gradients of a one-device step), spawns ``_torch_ranks.body_mesh`` at
every world size at once, and runs the reference's single-device steps
while the ranks work.  The 1- and 4-rank groups restore the 2-rank group's
checkpoint once it is committed.  The tests read what the ranks returned.

- The mesh step (``launch/steps.make_step``, FSDP over "data"): every
  family's SMOKE config (float32), and granite-moe at a capacity factor
  that drops pairs.  Losses within rtol 1e-5 of the reference's
  single-device ``make_train_step`` (JAX on the CPU) and of the port's
  one-device step; the new parameters too, at that step's own bar against
  the reference (``test_torch_train_families.py``: within 1e-4, scaled by
  the leaf's magnitude above 1; Adam's update is divided by the gradient's
  root mean square, so the last bits of a near-zero gradient move a
  parameter by up to 2 lr), and at one rank bitwise the port's one-device
  step wherever the one-device autograd graph adds no tensor's gradient
  from three uses or more (dense, moe, ssm, vlm: measured bitwise; zamba2's
  embeddings and whisper's encoder output feed every layer).
- ``compress_sharded_gradients``: bitwise across world sizes, and bitwise
  the single-process ``compress_gradients`` on the gathered gradient in
  the reference's layout, under both pencil transforms, in one call and in
  calls cut to 3 pencils (the bound of a call's bytes lowered; a rank left
  with one pencil pairs it with a zero line).
- Gradient scaling: each rank's gradient shards, out of the reduction,
  are the one-device gradient's (the mean over the batch's ranks: a sum
  would be 2 or 4 times it), at every world size, replicated batch too.
- Per-rank state bytes: the rules' share (``MeshLayout.share_bytes``);
  the whole parameters alive at once: one segment's at most.
- Loss scaling: a batch of 2 rows splits over 2 ranks and is replicated
  over 4, where the step is the one-device step's, loss to the bit.
- Prefill and decode over the mesh: logits within 1e-5 of the one-device
  bundle's, a batch that does not divide (2 rows over 4 ranks) replicated.
- A checkpoint saved at world size 2 (after an injected failure and a
  restart) restores bitwise at 1 and 4 ranks, which then train on; only
  data rank 0 decodes it, one leaf at a time.
- A "model" axis of 2 builds a layout, a step and a Trainer (its steps are
  ``tests/test_torch_tp.py``'s).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
import test_torch_lm_parity as lm
from repro.launch.steps import make_train_step as r_make_train_step
from repro.models import model as r_model
from repro.optim.adamw import AdamW as RAdamW
from repro_torch import convert
from repro_torch.core.engine import CorrectionEngine
from repro_torch.launch import steps
from repro_torch.optim import compress_gradients
from repro_torch.optim.adamw import AdamW

WORLDS = (1, 2, 4)
BATCH, SEQ = 4, 24
#: (label, arch, config overrides); the second granite-moe drops pairs
CASES = [("dense", "qwen2-0.5b", {}), ("moe", "granite-moe-3b-a800m", {}),
         ("moe_drops", "granite-moe-3b-a800m", {"capacity_factor": 0.5}), ("ssm", "mamba2-2.7b", {}),
         ("hybrid", "zamba2-7b", {}), ("vlm", "llava-next-mistral-7b", {}), ("audio", "whisper-tiny", {}),
         ("dense_rows2", "qwen2-0.5b", {})]
#: batch rows by case (default BATCH): 2 rows split over 2 ranks and are
#: replicated over 4, where every rank computes the whole batch
ROWS = {"dense_rows2": 2}
#: where the one-device graph sums a tensor's gradient from three uses or more
NOT_BITWISE_AT_ONE = {"hybrid", "audio"}
COMPRESS = dict(bits=8, E_rel=1e-2, Delta_rel=5e-5, block=512)
COMPRESS_CASES = [("hybrid", "zamba2-7b"), ("dense", "qwen2-0.5b")]
#: each arch under both pencil transforms, in one call and in calls of 3
#: whole-block pencils
COMPRESS_KEYS = [("hybrid", "pallas", None), ("hybrid", "xla", 3), ("dense", "xla", None), ("dense", "pallas", 3)]
SERVE = [("dense", "qwen2-0.5b", 4), ("dense_b2", "qwen2-0.5b", 2), ("ssm", "mamba2-2.7b", 4),
         ("hybrid", "zamba2-7b", 4), ("moe", "granite-moe-3b-a800m", 4)]
PROMPT, SERVE_LEN = 6, 9


def _batch(cfg, seed=1, rows=BATCH):
    seq = lm.vision(cfg) + SEQ if cfg.family == "vlm" else SEQ
    text = seq - lm.vision(cfg)
    return lm.batch(cfg, lm.tokens(cfg, b=rows, s=text, seed=seed))


def _one_device(cfg, state, batch, engine=None):
    bundle = lm.build_model(cfg, device="cpu")
    params = bundle.load({k: torch.from_numpy(v) for k, v in state.items()})
    opt = AdamW(warmup_steps=2)
    params, _, loss = steps.make_train_step(bundle, opt, engine)(params, opt.init(params.state_dict()), batch)
    return float(loss), {k: v.detach().numpy() for k, v in params.state_dict().items()}


def _grads(cfg, state, batch):
    bundle = lm.build_model(cfg, device="cpu")
    model = bundle.load({k: torch.from_numpy(v) for k, v in state.items()})
    named = dict(model.named_parameters())
    loss = bundle.loss(model, batch)
    return {k: g.numpy() for k, g in zip(named, torch.autograd.grad(loss, list(named.values())))}


def _state(cfg, seed=0):
    """Parameters of ``cfg`` (the port's init, float32 numpy by state dict
    name); the reference gets them through ``convert``."""
    model = lm.build_model(cfg, device="cpu").init(torch.Generator().manual_seed(seed))
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    base = tmp_path_factory.mktemp("mesh")
    train, want = [], {}
    for label, arch, overrides in CASES:
        _, cfg = lm.configs(arch, **overrides)
        state = _state(cfg)
        train.append((label, arch, overrides, state, _batch(cfg, rows=ROWS.get(label, BATCH))))

    compress = []
    for label, arch in COMPRESS_CASES:
        _, cfg = lm.configs(arch)
        grads = _grads(cfg, _state(cfg), _batch(cfg))
        ref_tree = convert.lm_params_to_reference({k: torch.from_numpy(v) for k, v in grads.items()}, cfg)
        for key in [k for k in COMPRESS_KEYS if k[0] == label]:
            _, impl, per_call = key
            out = compress_gradients(ref_tree, engine=CorrectionEngine(device="cpu", fft_impl=impl), **COMPRESS)
            single = {k: v.numpy() for k, v in convert.lm_params_from_reference(out, cfg).items()}
            want[("compress",) + key] = {"single": single, "grads": grads}
            compress.append((key, arch, grads, COMPRESS, per_call, impl))

    serve = []
    for label, arch, rows in SERVE:
        _, cfg = lm.configs(arch, **({"capacity_factor": 8.0} if "moe" in arch else {}))
        state = _state(cfg)
        toks = lm.tokens(cfg, b=rows, s=SERVE_LEN, seed=3)
        bundle = lm.build_model(cfg, device="cpu")
        model = bundle.load({k: torch.from_numpy(v) for k, v in state.items()})
        cache = bundle.init_cache(rows, SERVE_LEN + 4)
        logits, cache = bundle.prefill(model, {"tokens": toks[:, :PROMPT]}, cache)
        seq = [logits.numpy()]
        for t in range(PROMPT, SERVE_LEN):
            logits, cache = bundle.decode(model, toks[:, t : t + 1], cache)
            seq.append(logits.numpy())
        want[("serve", label)] = seq
        serve.append((label, arch, state, toks, PROMPT))

    # the checkpoint: saved at 2 ranks (a failure injected at step 1, a
    # restart, steps to 3), restored at 1 and 4 ranks once committed; a
    # "model" axis of 2 tried at 2 ranks
    inputs = {"train": train, "compress": compress, "serve": serve, "pod_train": train[:1],
              "checkpoint": {"worlds": [1, 2, 4], "saver": 2, "dir": str(base / "ckpt"), "steps": 2, "fail_at": 1,
                             "more": 1, "arch": "qwen2-0.5b"},
              "model_axis_worlds": [2]}
    join = ranks.start_worlds("mesh", WORLDS, base / "ranks", timeout=300.0, inputs=inputs)

    # while the ranks run: the reference's single-device step (compiled in
    # threads: XLA compiles without the interpreter lock) and the port's
    # one-device step on the same parameters and batches
    def reference(case):
        label, arch, overrides, state, batch = case
        rcfg, cfg = lm.configs(arch, **overrides)
        params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), convert.lm_params_to_reference(
            {k: torch.from_numpy(v) for k, v in state.items()}, cfg))
        opt = RAdamW(warmup_steps=2)
        r_params, _, r_loss = jax.jit(r_make_train_step(r_model.build_model(rcfg), opt))(
            params, opt.init(params), lm.jnp_batch(batch))
        r_new = convert.lm_params_from_reference(jax.tree.map(np.asarray, r_params), cfg)
        return {"ref_loss": float(r_loss), "ref": {k: np.asarray(v) for k, v in r_new.items()}, "cfg": cfg}

    with ThreadPoolExecutor(4) as pool:
        refs = list(pool.map(reference, train))
    for (label, arch, overrides, state, batch), ref in zip(train, refs):
        grads = _grads(ref["cfg"], state, batch)  # first: the one-device step updates ``state`` in place
        one_loss, one_new = _one_device(ref["cfg"], state, batch)
        want[label] = {**ref, "one_loss": one_loss, "one": one_new, "grads": grads}
    return {"ranks": join(), "want": want}


def _ranks(results, world):
    got = results[world]
    if isinstance(got, str):
        pytest.fail(f"world size {world}: {got}")
    return got


def _params_close(got, want, what):
    for k, w in want.items():
        atol = 1e-4 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[k], w, rtol=0, atol=atol, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_mesh_step_matches_the_single_device_steps(mesh, label, world):
    want = mesh["want"][label]
    got = _ranks(mesh["ranks"], world)
    losses = [r["train"][label]["loss"] for r in got]
    assert len(set(losses)) == 1, "ranks report different losses"
    np.testing.assert_allclose(losses[0], want["ref_loss"], rtol=1e-5)
    np.testing.assert_allclose(losses[0], want["one_loss"], rtol=1e-5)
    params = got[0]["train"][label]["params"]
    assert set(params) == set(want["one"])
    _params_close(params, want["ref"], "against the reference")
    _params_close(params, want["one"], "against the one-device step")
    if world == 1 and label not in NOT_BITWISE_AT_ONE:
        assert losses[0] == want["one_loss"]
        for k, w in want["one"].items():
            np.testing.assert_array_equal(params[k], w, err_msg=k)
    if ROWS.get(label, BATCH) % world:
        # replicated: every rank the whole batch, and no reduction
        assert losses[0] == want["one_loss"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_mesh_gradients_are_the_one_device_gradients(mesh, label, world):
    """Loss scaling: the reduced gradient shards, gathered, are the
    one-device gradient of the global batch's mean loss, leaf by leaf
    within 1e-5 of the leaf's largest value (AdamW's first step is nearly
    blind to a gradient's scale, so the parameters alone cannot show it)."""
    want = mesh["want"][label]["grads"]
    for rank, r in enumerate(_ranks(mesh["ranks"], world)):
        got = r["train"][label]["grads"]
        if rank:
            assert got is None  # gathered to rank 0
            continue
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()),
                                       err_msg=f"world {world}: {k}")


@pytest.mark.parametrize("world", (2, 4))
def test_one_segment_is_gathered_at_a_time(mesh, world):
    """The gathered (whole) parameters alive at once never exceed the
    largest segment's (each segment's are dropped before the next's are
    gathered, forward and backward), well under the whole model, and none
    outlives the step."""
    for r in _ranks(mesh["ranks"], world):
        for label, t in r["train"].items():
            g = t["gathered"]
            assert 0 < g["max_live_bytes"] <= g["largest_segment_bytes"], (label, g)
            assert g["max_live_bytes"] < 0.75 * g["model_bytes"], (label, g)
            assert g["live"] == 0, (label, g)


def test_a_pod_axis_splits_the_batch_over_pod_and_data(mesh):
    """(pod 2, data 2, model 1) on 4 ranks: the batch split over both axes
    (one flattened group), the parameters over "data" and replicated over
    "pod"; the step as the data mesh's."""
    label = CASES[0][0]
    want = mesh["want"][label]
    got = _ranks(mesh["ranks"], 4)
    losses = [r["pod_train"][label]["loss"] for r in got]
    assert len(set(losses)) == 1
    np.testing.assert_allclose(losses[0], want["ref_loss"], rtol=1e-5)
    _params_close(got[0]["pod_train"][label]["params"], want["ref"], "against the reference")
    one = _ranks(mesh["ranks"], 1)[0]["train"][label]["param_bytes"]
    assert got[0]["pod_train"][label]["state_bytes"] == got[0]["pod_train"][label]["share_bytes"]
    assert got[0]["pod_train"][label]["param_bytes"] < one
    assert all(len(p) == 3 for p in got[0]["pod_train"][label]["placements"].values())


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_each_rank_holds_the_rules_share(mesh, label, world):
    cfg = mesh["want"][label]["cfg"]
    for rank, r in enumerate(_ranks(mesh["ranks"], world)):
        t = r["train"][label]
        assert t["state_bytes"] == t["share_bytes"], (rank, t["state_bytes"], t["share_bytes"])
        # args: the global shapes of the state dict; placements: one per mesh dim
        assert set(t["args"]) == set(mesh["want"][label]["one"])
        assert all(len(p) == 2 for p in t["placements"].values())
    one = _ranks(mesh["ranks"], 1)[0]["train"][label]["param_bytes"]
    split = _ranks(mesh["ranks"], world)[0]["train"][label]["param_bytes"]
    # the big tensors split: a rank holds little more than 1/world of them
    assert split <= one / world + 0.35 * one, (label, cfg.name, split, one)


@pytest.mark.parametrize("case", COMPRESS_KEYS, ids=str)
def test_mesh_compression_is_bitwise_the_single_process_call(mesh, case):
    want = mesh["want"][("compress",) + case]
    for world in WORLDS:
        got = _ranks(mesh["ranks"], world)[0]["compress"][case]
        for k, w in want["single"].items():
            np.testing.assert_array_equal(got["grads"][k], w, err_msg=f"world {world}: {k}")
        if world == 1 and case[2] is None:
            assert len(got["calls"]) == len({b for b, _ in got["calls"]})  # one call a pencil length
    # the correction acted, and some leaf changed
    assert any(not np.array_equal(want["single"][k], want["grads"][k]) for k in want["grads"])


def test_cut_calls_pair_a_lone_pencil_with_a_zero_line(mesh):
    """With calls of 3 pencils, some rank's call holds one pencil of a larger
    batch: it runs as two rows (its pencil and a zero line)."""
    lone = False
    for world in (2, 4):
        for r in _ranks(mesh["ranks"], world):
            for case, got in r["compress"].items():
                lone |= case[2] == 3 and any(rows == 2 for _, rows in got["calls"])
    assert lone


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("label", [s[0] for s in SERVE])
def test_prefill_and_decode_over_the_mesh(mesh, label, world):
    want = mesh["want"][("serve", label)]
    rows = next(r for lab, _, r in SERVE if lab == label)
    got = _ranks(mesh["ranks"], world)
    for step, w in enumerate(want):
        if rows % world:
            parts = [got[0]["serve"][label]["logits"][step]]  # replicated: every rank the whole batch
            assert all(np.array_equal(r["serve"][label]["logits"][step], parts[0]) for r in got)
        else:
            parts = [r["serve"][label]["logits"][step] for r in got]
        np.testing.assert_allclose(np.concatenate(parts), w, rtol=0, atol=1e-5, err_msg=f"step {step}")
        assert np.isfinite(np.concatenate(parts)).all()


def test_a_checkpoint_saved_at_two_ranks_restores_at_one_and_four(mesh):
    saved = _ranks(mesh["ranks"], 2)
    assert saved[0]["checkpoint"]["failed"] and saved[1]["checkpoint"]["failed"]
    assert saved[0]["checkpoint"]["start"] == 1  # the failure at step 1, after step 1's save
    final = saved[0]["checkpoint"]["final"]
    assert saved[1]["checkpoint"]["final"] is None  # rank 0 holds the gathered state
    losses = {}
    for world in (1, 4):
        got = _ranks(mesh["ranks"], world)
        ck = got[0]["checkpoint"]
        assert ck["start"] == 3
        assert len(ck["restored"]) == len(final)
        for a, b in zip(ck["restored"], final):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        losses[world] = ck["losses"]
        assert all(r["checkpoint"]["losses"] == ck["losses"] for r in got)
    np.testing.assert_allclose(losses[4], losses[1], rtol=1e-5)
    assert all(np.isfinite(r["checkpoint"]["losses"]).all() for r in saved)
    # straggler tracking runs as on one device: no window of 5 steps yet
    assert all(r["checkpoint"]["straggler_events"] == [] for w in WORLDS for r in _ranks(mesh["ranks"], w))


@pytest.mark.parametrize("world", WORLDS)
def test_only_data_rank_zero_reads_a_checkpoint(mesh, world):
    """A restore over the mesh decodes every leaf once, on data rank 0,
    which hands each tensor out as it comes; the other ranks read no file."""
    got = _ranks(mesh["ranks"], world)
    n_leaves = len(_ranks(mesh["ranks"], 2)[0]["checkpoint"]["final"])
    assert [r["checkpoint"]["decoded_leaves"] for r in got] == [n_leaves] + [0] * (world - 1)


def test_a_model_axis_of_two_raises(mesh):
    """A (1, 2) mesh: the layout, ``make_step`` and a Trainer build, each
    rank holding its (data, model) blocks, every block its share."""
    got = _ranks(mesh["ranks"], 2)
    for r in got:
        m = r["model_axis"]
        assert m["layout"] == (1, 2) and m["make_step"] == "MeshTrainStep", m
        assert m["trainer"]["state_bytes"] == m["trainer"]["share_bytes"], m
    assert [r["model_axis"]["model_rank"] for r in got] == [0, 1]


def test_mesh_axes_with_a_model_axis_of_one_are_accepted():
    """The models take the mesh's axes as layout hints, of a "model" axis of
    1 or 2: without a tensor-parallel context the loss is the hint-free one
    bitwise."""
    rcfg, cfg = lm.configs("granite-moe-3b-a800m")
    bundle = lm.build_model(cfg, device="cpu")
    model = bundle.load({k: torch.from_numpy(np.asarray(v)) for k, v in
                         convert.lm_params_from_reference(lm.ref_params(rcfg), cfg).items()})
    batch = _batch(cfg)
    with torch.no_grad():
        plain = bundle.loss(model, batch)
        hinted_cfg = dataclasses.replace(cfg, mesh_axes=(("data", 4), ("model", 1)))
        hinted = lm.build_model(hinted_cfg, device="cpu").loss(model, batch)
        hinted_tp = lm.build_model(dataclasses.replace(cfg, mesh_axes=(("data", 2), ("model", 2))),
                                   device="cpu").loss(model, batch)
    assert torch.equal(plain, hinted) and torch.equal(plain, hinted_tp)
