"""gloo ranks for the port's multi-rank CPU tests (no JAX here).

:func:`run_worlds` starts one group of spawned processes per world size, all
at once, each rank running a module-level body of this file in a gloo
process group (``file://`` init under the caller's directory) and pickling
what the body returns; it returns ``{world: [result of rank 0, 1, ...]}``.
Every group is joined under its own deadline and killed on expiry, so a hung
collective fails the tests that read it instead of the whole run.

The bodies build their inputs from fixed seeds, so every rank of every world
size sees the same field; the test modules hold the results against each
other, against a single-process computation and against the reference.
"""

from __future__ import annotations

import dataclasses
import math
import multiprocessing
import os
import pickle
import time
import traceback

import numpy as np

# transforms: 3-D and 2-D, even and uneven slabs at 2 and 4 ranks, both
# parity classes, axes shorter than the rank count, odd last axes
FFT_SHAPES = [(16, 8, 12), (16, 8, 10), (12, 10, 14), (10, 6, 9), (5, 3, 7), (2, 16, 10), (16, 2, 6),
              (24, 30), (30, 48), (9, 7), (32, 62)]

# whole-field codec: "bitwise" even and uneven (2 rows over 4 ranks),
# "bound" uneven, and 2-D of both classes (13 and 10 half columns: uneven)
CODEC_SHAPES = [(16, 8, 12), (2, 16, 10), (9, 8, 10), (32, 24), (12, 18)]
PSPEC_SHAPES = [(16, 8, 12), (9, 8, 10), (12, 18)]


def codec_field(shape, seed=3):
    """A positive field with a spectrum (mean near 1), float32."""
    rng = np.random.default_rng(seed)
    return (1.0 + 0.5 * rng.standard_normal(shape)).astype(np.float32)


def codec_configs(shape):
    """name -> FFCzConfig keyword arguments of the codec cases."""
    n = int(np.prod(shape))
    mask = np.zeros(shape, dtype=bool)
    mask[tuple(slice(s // 4, max(s // 4 + 1, 3 * s // 4)) for s in shape)] = True
    return {
        "Delta_abs": dict(E_abs=0.02, E_rel=None, Delta_abs=0.2 * 0.02 * np.sqrt(n), Delta_rel=None),
        "Delta_rel": dict(E_rel=1e-2, Delta_rel=1e-3),
        "pspec_rel": dict(E_rel=1e-2, Delta_rel=None, pspec_rel=1e-2),
        "E_roi": dict(E_rel=1e-2, Delta_rel=1e-3, E_roi=mask),
        "packed": dict(E_rel=1e-2, Delta_rel=1e-3, fft_impl="packed"),
        "warm_check_every": dict(E_rel=1e-2, Delta_rel=1e-3, check_every=3),
    }


def backend_tensors(scale=1.0):
    """The reference's sharded-backend batch: 5 + 3 + 1 = 9 blocks of 512."""
    rng = np.random.default_rng(7)
    return [
        (rng.standard_normal(2500) * 0.02 * scale).astype(np.float32),
        (rng.standard_normal((32, 48)) * 0.01 * scale).astype(np.float32),
        (rng.standard_normal(100) * 0.01 * scale).astype(np.float32),
    ]


BACKEND_E, BACKEND_D = [0.03, 0.02, 0.05], [0.4, 0.5, 0.2]


def psum_inputs(rank, n=4097):
    """Rank ``rank``'s gradient shard: (one with the same planted max on
    every rank, one whose max differs by rank)."""
    rng = np.random.default_rng(100 + rank)
    same = rng.standard_normal(n).astype(np.float32)
    same[7] = np.float32(8.0)
    other = (rng.standard_normal(n) * (1 + rank)).astype(np.float32)
    return same, other


def _mesh(world):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", (world,), mesh_dim_names=("data",))


def _np(t):
    return t.detach().cpu().numpy()


def _outside_is_zero(a, true_shape):
    """Every entry of ``a`` outside its leading ``true_shape`` block is 0."""
    outside = np.ones(a.shape, dtype=bool)
    outside[tuple(slice(0, t) for t in true_shape)] = False
    return bool((a[outside] == 0).all())


# ---------------------------------------------------------------------------
# rank bodies


def body_transforms(rank, world):
    """pencil_rfftn / pencil_irfftn of every FFT_SHAPES field, gathered."""
    import torch

    from repro_torch.sharding import dist_fft

    mesh = _mesh(world)
    out = {}
    for i, shape in enumerate(FFT_SHAPES):
        x = np.random.default_rng(i).standard_normal(shape).astype(np.float32)
        spectra = []
        for chunks in (1, 2, 3):
            field = dist_fft.ShardedField.shard(x, mesh, overlap_chunks=chunks)
            local = dist_fft.pencil_rfftn(field)
            assert tuple(local.shape) == field.local_freq_shape
            padded = dist_fft.gather_to_host(local, field.group, world, field.freq_axis)
            spectra.append(field.freq_to_host(local))
        X = spectra[1]
        inv = dist_fft.pencil_irfftn(X, shape, mesh)
        foreign = np.pad(X, [(0, p - t) for p, t in zip(dist_fft.padded_freq_shape(shape, 8), X.shape)])
        packed = dist_fft.irfftn_local(field.to_local(field.pad_freq_np(X), freq=True), field.dist_spec,
                                       fft_impl="packed")
        # a parity request selects nothing: the same slab, spectrum and
        # inverse whatever is asked, and the reference's class reported
        inert = True
        for p in ("auto", "bitwise", "bound"):
            asked = dist_fft.ShardedField.shard(x, mesh, parity=p)
            inert &= torch.equal(asked.local, field.local) and torch.equal(dist_fft.pencil_rfftn(asked), local)
            inert &= np.array_equal(dist_fft.pencil_irfftn(X, shape, mesh, parity=p).to_host(), inv.to_host())
            inert &= asked.parity == dist_fft.classify_parity(shape, world)
        out[shape] = {
            "parity_inert": bool(inert),
            "X": X,
            "chunking_neutral": all(np.array_equal(s, X) for s in spectra),
            "pad_zero": _outside_is_zero(padded, X.shape),
            "inverse": inv.to_host(),
            "inverse_local_pad_zero": _outside_is_zero(dist_fft.gather_to_host(inv.local, inv.group, world), shape),
            "inverse_foreign_layout": dist_fft.pencil_irfftn(foreign, shape, mesh).to_host(),
            "inverse_packed": field.spatial_to_host(packed),
            "to_host": field.to_host(),
        }
    return out


def body_sharded(rank, world):
    """The codec, the sharded backend, the spectrum, compressed_psum and
    elastic re-planning on one process group."""
    import torch

    from repro_torch.compressors import get_compressor
    from repro_torch.core.engine import CorrectionEngine
    from repro_torch.core.ffcz import FFCz, FFCzConfig
    from repro_torch.core.spectrum import power_spectrum
    from repro_torch.optim import compressed_psum
    from repro_torch.runtime.elastic import replan_mesh
    from repro_torch.sharding import ShardedField, classify_parity

    mesh = _mesh(world)
    out = {"codec": {}, "pspec": {}, "backend": {}}
    for shape in CODEC_SHAPES:
        x = codec_field(shape)
        for name, kw in codec_configs(shape).items():
            codec = FFCz(get_compressor("szlike"), FFCzConfig(**kw), device="cpu")
            blob = codec.compress(ShardedField.shard(x, mesh))
            back = codec.decompress_sharded(blob, mesh)
            out["codec"][(shape, name)] = {
                "bytes": blob.to_bytes(),
                "payload": blob.payload_bytes(),
                "iterations": blob.stats.iterations,
                "converged": blob.stats.converged,
                "margins": (blob.stats.spatial_margin, blob.stats.frequency_margin),
                "sharded_decode_bitwise": bool(np.array_equal(back.to_host(), codec.decompress(blob))),
            }
            if name == "warm_check_every":
                # warm start: the next frame's loop seeded from this one's spectrum
                engine = codec.engine
                cfg = FFCzConfig(warm_start=True, **kw)
                field = ShardedField.shard(x * np.float32(1.01), mesh)
                plan = engine.plan_field(field, cfg)
                eps0 = codec.base.decompress(codec.base.compress(field.to_host(), plan.E_proj)) - field.to_host()
                cold = engine.execute_field(ShardedField.shard(eps0, mesh), plan)
                warm = engine.execute_field(ShardedField.shard(eps0, mesh), plan, warm_freq=cold.freq)
                out["codec"][(shape, "warm")] = {"cold": (cold.eps, cold.iterations),
                                                 "warm": (warm.eps, warm.freq, warm.iterations, warm.converged)}
    for shape in PSPEC_SHAPES:
        field = ShardedField.shard(codec_field(shape, seed=5), mesh)
        k, pk = power_spectrum(field)
        out["pspec"][shape] = (_np(k), _np(pk))

    tensors = backend_tensors()
    for impl in ("xla", "packed", "pallas"):
        for block in (512, 511):
            sharded = CorrectionEngine(backend="sharded", mesh=mesh, fft_impl=impl)
            batched = CorrectionEngine(backend="batched", fft_impl=impl, device="cpu")
            case = {}
            for label, engine in (("sharded", sharded), ("batched", batched)):
                corr, edits, stats = engine.correct(tensors, BACKEND_E, BACKEND_D, block=block, return_edits=True)
                warm = [f for _, f in edits]
                wcorr, wedits, wstats = engine.correct(backend_tensors(1.05), BACKEND_E, BACKEND_D, block=block,
                                                       return_edits=True, warm_freq=warm)
                handle = engine.correct_async(tensors, BACKEND_E, BACKEND_D, block=block)
                acorr, astats = handle.result()
                case[label] = {
                    name: [_np(t) for t in ts] for name, ts in (
                        ("corrected", corr), ("spat", [s for s, _ in edits]), ("freq", [f for _, f in edits]),
                        ("warm_corrected", wcorr), ("warm_freq", [f for _, f in wedits]),
                        ("async_corrected", acorr),
                        ("stats", [stats.iterations, stats.converged, stats.block_iterations,
                                   stats.block_converged]),
                        ("warm_stats", [wstats.iterations, wstats.converged, wstats.block_iterations,
                                        wstats.block_converged]),
                        ("async_stats", [astats.block_iterations, astats.block_converged]))
                }
            out["backend"][(impl, block)] = case

    # what the sharded whole-field loop refuses, as the reference does
    out["refusals"] = {}
    x = codec_field(CODEC_SHAPES[0])
    for label, kw in (("pallas", dict(fft_impl="pallas")), ("use_kernels", dict(use_kernels=True))):
        codec = FFCz(get_compressor("szlike"), FFCzConfig(E_rel=1e-2, Delta_rel=1e-3, **kw), device="cpu")
        try:
            codec.compress(ShardedField.shard(x, mesh))
            out["refusals"][label] = None
        except ValueError as e:
            out["refusals"][label] = str(e)
    # a parity request selects nothing: packed blobs of a "bound"-class
    # shape under each request, byte for byte the same
    bound_shape = next(s for s in CODEC_SHAPES if classify_parity(s, world) == "bound")
    codec = FFCz(get_compressor("szlike"), FFCzConfig(E_rel=1e-2, Delta_rel=1e-3, fft_impl="packed"),
                 device="cpu")
    out["parity_payloads"] = [codec.compress(ShardedField.shard(codec_field(bound_shape), mesh, parity=p))
                              .payload_bytes() for p in ("auto", "bitwise", "bound")]

    same, other = psum_inputs(rank)
    out["psum"] = {"same": _np(compressed_psum(torch.from_numpy(same), mesh)),
                   "other": _np(compressed_psum(torch.from_numpy(other), mesh, bits=6, E_rel=0.05))}
    replanned = replan_mesh(preferred_model=2)
    out["elastic"] = (tuple(replanned.shape), tuple(replanned.mesh_dim_names))
    return out


def _data_mesh(world, model=1):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh((world // model, model), ("data", "model"))


def _host(layout, tree):
    """Rank 0's whole copy of a tree of shards (numpy), None elsewhere."""
    out = {k: layout.gather_to_rank0(k, v) for k, v in tree.items()}
    return {k: v.numpy() for k, v in out.items()} if layout.rank == 0 else None


def _contiguous_collectives():
    """Make gloo refuse a strided tensor in a collective, as NCCL does."""
    import torch
    import torch.distributed as dist

    def strict(name, fn):
        def call(*args, **kw):
            for a in (*args, *kw.values()):
                for t in a if isinstance(a, (list, tuple)) else (a,):
                    if isinstance(t, torch.Tensor) and not t.is_contiguous():
                        raise ValueError(f"{name} of a strided tensor {tuple(t.shape)} (NCCL refuses it)")
            return fn(*args, **kw)
        return call

    for name in ("all_reduce", "all_gather", "broadcast", "all_to_all_single", "reduce_scatter_tensor", "scatter"):
        setattr(dist, name, strict(name, getattr(dist, name)))


def body_mesh(rank, world, inputs):
    """The mesh train step of every case (one step from the given
    parameters), the gradients compressed over the mesh, prefill and decode
    over the mesh, and a mesh Trainer that checkpoints (``inputs`` built by
    tests/test_torch_mesh_train.py).  Collectives refuse strided tensors."""
    import dataclasses

    import torch

    _contiguous_collectives()

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.engine import CorrectionEngine
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.grad_compress import compress_sharded_gradients
    from repro_torch.sharding import fsdp
    from repro_torch.sharding.rules import mesh_sizes

    from repro_torch.launch.mesh import make_mesh

    mesh = _data_mesh(world)
    out = {"train": {}, "compress": {}, "serve": {}, "pod_train": {}}
    pod_mesh = make_mesh((2, 2, 1), ("pod", "data", "model")) if inputs.get("pod_train") and world == 4 else None
    cases = [("train", mesh, c) for c in inputs["train"]]
    cases += [("pod_train", pod_mesh, c) for c in inputs.get("pod_train", ()) if world == 4]
    for kind, m, (label, arch, overrides, state, batch) in cases:
        cfg = get_smoke_config(arch, **overrides)
        step, args, in_sh, out_sh = steps.make_step(cfg, "train_4k", m, optimizer=AdamW(warmup_steps=2))
        L = step.layout
        params = {k: L.shard(k, torch.from_numpy(v)) for k, v in state.items()}
        opt = step.optimizer.init(params)
        gathered = _watch_gathers(step)
        grads = _watch_grads(step)
        new, opt, loss = step(params, opt, batch)
        share = L.state_bytes(new) + L.state_bytes(opt)
        out[kind][label] = {"loss": float(loss), "params": _host(L, new), "state_bytes": share,
                            "gathered": gathered, "grads": _host(L, grads),
                            "share_bytes": L.share_bytes(), "param_bytes": L.state_bytes(new),
                            "args": {k: tuple(v.shape) for k, v in args[0].items()},
                            "placements": {k: [repr(p) for p in v] for k, v in in_sh[0].items()}}

    from repro_torch.optim import grad_compress

    for label, arch, grads, kw, per_call, impl in inputs["compress"]:
        cfg = get_smoke_config(arch)
        cfg = dataclasses.replace(cfg, mesh_axes=tuple(mesh_sizes(mesh).items()))
        L = fsdp.MeshLayout(cfg, mesh)
        shards = {k: L.shard(k, torch.from_numpy(v)) for k, v in grads.items()}
        calls = []

        class Recording(CorrectionEngine):
            def correct(self, tensors, E, Delta, block=4096, **k):
                calls.append((block, sum(-(-t.numel() // block) for t in tensors)))
                return super().correct(tensors, E, Delta, block=block, **k)

        bound = grad_compress._CALL_BYTES
        if per_call is not None:  # calls of ``per_call`` whole-block pencils
            grad_compress._CALL_BYTES = per_call * 4 * kw["block"]
        try:
            got = compress_sharded_gradients(shards, L, fsdp.reference_leaves(cfg, list(L.shapes)),
                                             engine=Recording(device="cpu", fft_impl=impl), **kw)
        finally:
            grad_compress._CALL_BYTES = bound
        out["compress"][label] = {"grads": _host(L, got), "calls": calls}

    for label, arch, state, toks, prompt in inputs["serve"]:
        cfg = get_smoke_config(arch)
        pre, _, _, pre_out = steps.make_step(cfg, "prefill_32k", mesh)
        dec = steps.make_step(cfg, "decode_32k", mesh)[0]
        L = pre.layout
        params = {k: L.shard(k, torch.from_numpy(v)) for k, v in state.items()}
        split = L.batch_split(toks.shape[0])
        cache = pre.bundle.init_cache(toks.shape[0] // split.size, toks.shape[1] + 4)
        batch = {"tokens": toks[:, :prompt]}
        logits, cache = pre(params, batch, cache)
        seq = [logits.numpy()]
        for t in range(prompt, toks.shape[1]):
            logits, cache = dec(params, toks[:, t : t + 1], cache)
            seq.append(logits.numpy())
        out["serve"][label] = {"rows": split.rows(toks.shape[0]), "logits": seq}

    ck = inputs.get("checkpoint")
    if ck is not None and world in ck["worlds"]:
        out["checkpoint"] = _mesh_trainer(rank, world, mesh, ck)
    if world in inputs.get("model_axis_worlds", ()):
        out["model_axis"] = _model_axis(world)
    return out


def _watch_gathers(step):
    """Track the whole parameters ``step``'s layout gathers that are alive
    at once (weak references: a tensor counts until it is freed); returns
    the record, filled as the step runs."""
    import weakref

    L = step.layout
    nbytes = {k: math.prod(L.shapes[k]) * torch_itemsize(L.dtypes[k]) for k in L.shapes}
    rec = {"live": 0, "max_live_bytes": 0, "model_bytes": sum(nbytes.values()),
           "largest_segment_bytes": max(sum(nbytes[n] for n in s.params) for s in step.segments)}
    gather = L.gather

    def watched(name, local):
        full = gather(name, local)
        if full is not local:
            rec["live"] += nbytes[name]
            rec["max_live_bytes"] = max(rec["max_live_bytes"], rec["live"])
            weakref.finalize(full, lambda n=nbytes[name]: rec.__setitem__("live", rec["live"] - n))
        return full

    L.gather = watched
    return rec


def _watch_grads(step):
    """The gradient shards ``step`` hands on from its reduction (before any
    compression), filled as the step runs."""
    got = {}
    loss_and_grads = step.loss_and_grads

    def watched(*args, **kw):
        loss, grads = loss_and_grads(*args, **kw)
        got.update(grads)
        return loss, grads

    step.loss_and_grads = watched
    return got


def torch_itemsize(dtype) -> int:
    import torch

    return torch.empty(0, dtype=dtype).element_size()


def _mesh_trainer(rank, world, mesh, ck):
    """A mesh Trainer: at ``ck["saver"]`` ranks it trains ``ck["steps"]``
    steps on ``ck["dir"]``, checkpointing each, with a failure injected at
    ``ck["fail_at"]`` and a restart; at the other world sizes it waits for
    that run's last checkpoint, restores a copy of it and trains
    ``ck["more"]`` steps."""
    import dataclasses
    import shutil
    import time

    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.engine import CorrectionEngine
    from repro_torch.runtime import SimulatedFailure, Trainer, TrainerConfig

    cfg = get_smoke_config(ck["arch"])
    cfg = dataclasses.replace(cfg, compression=dataclasses.replace(
        cfg.compression, grad_compression=True, grad_Delta_rel=5e-5, grad_block=256))
    run = dict(seq_len=24, global_batch=4, ckpt_every=1, ckpt_async=True, log_every=1)
    engine = CorrectionEngine(device="cpu", fft_impl="pallas")
    result = {}
    directory, steps = ck["dir"], ck["steps"]
    if world == ck["saver"]:
        t = Trainer(cfg, TrainerConfig(ckpt_dir=directory, inject_failure_at=ck["fail_at"], **run), mesh=mesh,
                    device="cpu", engine=engine)
        try:
            t.train(steps)
            result["failed"] = False
        except SimulatedFailure:
            result["failed"] = True
    else:
        # the saver's last step, committed (written under a temporary name,
        # then renamed), copied to this group's own directory
        last = f"step_{ck['fail_at'] + steps:012d}"
        deadline = time.monotonic() + ck.get("wait", 200.0)
        while not os.path.isdir(os.path.join(directory, last)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"no checkpoint {last} in {directory}")
            time.sleep(0.2)
        own = f"{directory}_{world}"
        if rank == 0:
            shutil.copytree(os.path.join(directory, last), os.path.join(own, last))
        dist.barrier()
        directory, steps = own, ck["more"]
    from repro_torch.checkpoint.codec import CheckpointCodec

    decoded, decode = [], CheckpointCodec.decode
    CheckpointCodec.decode = lambda self, data: decoded.append(len(data)) or decode(self, data)
    try:
        t = Trainer(cfg, TrainerConfig(ckpt_dir=directory, **run), mesh=mesh, device="cpu", engine=engine)
    finally:
        CheckpointCodec.decode = decode
    result["start"] = t.start_step
    result["decoded_leaves"] = len(decoded)
    state = t.state()
    result["restored"] = None if state is None else _state_np(state)
    got = t.train(steps)
    result["losses"] = [m["loss"] for m in got["metrics"]]
    result["straggler_events"] = got["straggler_events"]
    state = t.state()
    result["final"] = None if state is None else _state_np(state)
    return result


def _state_np(state):
    from repro_torch import tree

    return [leaf.detach().cpu().numpy() for leaf in tree.leaves(state)]


def _model_axis(world):
    """A "model" axis of 2: what each mesh entry point builds."""
    import tempfile

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.sharding import fsdp

    mesh = _data_mesh(world, model=2)
    cfg = get_smoke_config("qwen2-0.5b")
    layout = fsdp.MeshLayout(cfg, mesh)
    step = steps.make_step(cfg, "train_4k", mesh)[0]
    with tempfile.TemporaryDirectory() as d:
        t = Trainer(cfg, TrainerConfig(ckpt_dir=d), mesh=mesh, device="cpu")
        held = t.layout.state_bytes(t.params) + t.layout.state_bytes(t.opt_state)
    return {"layout": (layout.n_data, layout.n_model), "model_rank": layout.model_rank,
            "make_step": type(step).__name__, "trainer": {"state_bytes": held, "share_bytes": t.layout.share_bytes()}}


def body_tp(rank, world, inputs):
    """Tensor and expert parallelism (tests/test_torch_tp.py): on each mesh
    of ``inputs["meshes"][world]`` (a (data, model) shape and the cases it
    runs), two train steps of every case (the gradient blocks of the first
    out of the reduction, its global norm as AdamW reads it, the MoE
    routing counts of its forward, the parameters after the second),
    prefill and decode through ``MeshServe``, and
    ``compress_sharded_gradients`` of given gradients.  Collectives refuse
    strided tensors."""
    import torch

    _contiguous_collectives()

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.engine import CorrectionEngine
    from repro_torch.launch import steps
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.grad_compress import compress_sharded_gradients
    from repro_torch.sharding import fsdp, tp

    import logging

    cases = {c[0]: c for c in inputs["cases"]}
    out = {}
    route = moe_mod.route
    logged = []
    handler = logging.Handler()
    handler.emit = lambda record: logged.append(record.getMessage())
    logging.getLogger(tp.__name__).addHandler(handler)
    for shape, labels in inputs["meshes"].get(world, ()):
        mesh = _data_mesh(world, model=shape[1])
        for label in labels:
            _, arch, overrides, state, batches, serve = cases[label]
            cfg = get_smoke_config(arch, **overrides)
            step = steps.make_step(cfg, "train_4k", mesh, optimizer=AdamW(warmup_steps=2))[0]
            L = step.layout
            params = {k: L.shard(k, torch.from_numpy(v)) for k, v in state.items()}
            opt = step.optimizer.init(params)
            grads = _watch_grads(step)
            norms, routed = [], []
            norm_terms = step.norm_terms

            def watched_norm(names, norm_terms=norm_terms):
                reduce = norm_terms(names)

                def counted(terms):
                    terms = reduce(terms) if reduce is not None else terms
                    norms.append(float(torch.sqrt(sum(terms))))
                    return terms
                return counted

            def watched_route(*a, **kw):
                r = route(*a, **kw)
                if not torch.is_grad_enabled():  # the forward, not the backward's recompute
                    routed.append((int(r.keep.sum()), int(r.keep.numel())))
                return r

            step.norm_terms = watched_norm
            moe_mod.route = watched_route
            losses = []
            try:
                for i, batch in enumerate(batches):
                    params, opt, loss = step(params, opt, batch)
                    losses.append(float(loss))
                    if i == 0:
                        first = _host(L, grads)
                        routed_first = list(routed)
            finally:
                moe_mod.route = route
            rec = {"losses": losses, "grads": first, "norm": norms[0], "routed": routed_first,
                   "data_rank": L.data_rank, "model_rank": L.model_rank, "params": _host(L, params),
                   "state_bytes": L.state_bytes(params) + L.state_bytes(opt), "share_bytes": L.share_bytes(),
                   "ctx": {f: getattr(L.tp_ctx, f) for f in ("size", "heads", "mlp", "experts", "vocab")},
                   "uses": {k: (u.gather_model, u.index is not None, u.grad) for k, u in L.uses.items()}}

            pre = steps.make_step(cfg, "prefill_32k", mesh)[0]
            dec = steps.make_step(cfg, "decode_32k", mesh)[0]
            toks, stubs, prompt, max_len = serve
            split = L.batch_split(toks.shape[0])
            cache = pre.init_cache(toks.shape[0], max_len)
            params = {k: L.shard(k, torch.from_numpy(v)) for k, v in state.items()}  # the initial ones
            logits, cache = pre(params, {"tokens": toks[:, :prompt], **stubs}, cache)
            seq = [logits.numpy()]
            for t in range(prompt, toks.shape[1]):
                logits, cache = dec(params, toks[:, t : t + 1], cache)
                seq.append(logits.numpy())
            rec["serve"] = {"rows": split.rows(toks.shape[0]), "logits": seq,
                            "cache_bytes": L.state_bytes(cache)}
            out[(shape, label)] = rec

        for label, arch, grads_np, kw in inputs.get("compress", ()):
            if label not in labels:
                continue
            cfg = get_smoke_config(arch)
            L = fsdp.MeshLayout(cfg, mesh)
            blocks = {k: L.shard(k, torch.from_numpy(v)) for k, v in grads_np.items()}
            got = compress_sharded_gradients(blocks, L, fsdp.reference_leaves(cfg, list(L.shapes)),
                                             engine=CorrectionEngine(device="cpu", fft_impl="pallas"), **kw)
            out[(shape, "compress", label)] = _host(L, got)
        ck = inputs.get("checkpoint")
        if ck is not None and shape in ck["meshes"]:
            out[(shape, "checkpoint")] = _tp_trainer(rank, world, mesh, ck, shape)
    out["replicated_notes"] = logged
    return out


def _tp_trainer(rank, world, mesh, ck, shape):
    """A Trainer over a mesh with a "model" axis: ``ck["steps"]`` steps with
    a checkpoint each, then a new Trainer on the directory restores the
    last one (data rank 0 of model rank 0 decodes and scatters each leaf's
    blocks) and steps once more."""
    import os

    import torch.distributed as dist

    from repro_torch.checkpoint.codec import CheckpointCodec
    from repro_torch.configs import get_smoke_config
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = get_smoke_config(ck["arch"])
    directory = os.path.join(ck["dir"], f"{shape[0]}x{shape[1]}")
    run = TrainerConfig(ckpt_dir=directory, seq_len=24, global_batch=4, ckpt_every=1, ckpt_async=False,
                        log_every=1)
    t = Trainer(cfg, run, mesh=mesh, device="cpu")
    t.train(ck["steps"])
    saved = t.state()
    dist.barrier()
    decoded, decode = [], CheckpointCodec.decode
    CheckpointCodec.decode = lambda self, data: decoded.append(len(data)) or decode(self, data)
    try:
        again = Trainer(cfg, run, mesh=mesh, device="cpu")
    finally:
        CheckpointCodec.decode = decode
    start, restored = again.start_step, again.state()
    losses = again.train(1)["metrics"]
    return {"start": start, "decoded_leaves": len(decoded),
            "saved": None if saved is None else _state_np(saved),
            "restored": None if restored is None else _state_np(restored),
            "loss": losses[-1]["loss"], "held": again.layout.state_bytes(again.params)
            + again.layout.state_bytes(again.opt_state), "share": again.layout.share_bytes()}


BODIES = {"transforms": body_transforms, "sharded": body_sharded, "mesh": body_mesh, "tp": body_tp}


# ---------------------------------------------------------------------------
# the launcher


def _entry(rank, world, init_file, out_file, body, inputs_file=None):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        kw = {}
        if inputs_file is not None:
            with open(inputs_file, "rb") as f:
                kw["inputs"] = pickle.load(f)
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
        try:
            result = {"ok": BODIES[body](rank, world, **kw)}
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent
        result = {"error": traceback.format_exc()}
    with open(out_file, "wb") as f:
        pickle.dump(result, f)


def run_worlds(body: str, worlds, directory, timeout: float = 120.0, inputs=None):
    """Run ``body`` at each world size of ``worlds``, every group at once;
    ``{world: [rank results]}``, or ``{world: "error text"}`` for a group
    that failed or outran ``timeout`` seconds (its processes killed).
    ``inputs`` (pickled once) is handed to every rank's body."""
    return start_worlds(body, worlds, directory, timeout, inputs)()


def start_worlds(body: str, worlds, directory, timeout: float = 120.0, inputs=None):
    """:func:`run_worlds`, returning once the ranks are started: call the
    returned function for the results."""
    ctx = multiprocessing.get_context("spawn")
    inputs_file = None
    if inputs is not None:
        os.makedirs(str(directory), exist_ok=True)
        inputs_file = os.path.join(str(directory), f"{body}_inputs.pkl")
        with open(inputs_file, "wb") as f:
            pickle.dump(inputs, f)
    groups = {}
    for world in worlds:
        base = os.path.join(str(directory), f"{body}_{world}")
        os.makedirs(base, exist_ok=True)
        procs = [ctx.Process(target=_entry, args=(r, world, os.path.join(base, "init"),
                                                   os.path.join(base, f"rank{r}.pkl"), body, inputs_file),
                             daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        groups[world] = (base, procs, time.monotonic() + timeout)
    return lambda: _join(groups, timeout)


def _join(groups, timeout):
    results = {}
    for world, (base, procs, deadline) in groups.items():
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
        if hung:
            results[world] = f"{len(hung)} of {world} ranks still running after {timeout} s (killed)"
            continue
        ranks = []
        for r in range(world):
            path = os.path.join(base, f"rank{r}.pkl")
            if not os.path.exists(path):
                ranks = f"rank {r} wrote no result (exit code {procs[r].exitcode})"
                break
            with open(path, "rb") as f:
                got = pickle.load(f)
            if "error" in got:
                ranks = f"rank {r} failed:\n{got['error']}"
                break
            ranks.append(got["ok"])
        results[world] = ranks
    return results
