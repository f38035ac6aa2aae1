#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``
(into ``build/``), holds each kernel against its plain PyTorch twin on the
card at the main path's shapes, then drives ``FFCz.compress`` /
``FFCz.decompress`` with ``FFCzConfig(fft_impl="pallas")`` at full size and
rechecks both stored bounds in float64, drives the qwen2-0.5b dense LM at
full width (``ModelBundle.loss``, ``ServingEngine``, ``Trainer`` on one
device and over a one-rank data mesh), the moe,
ssm, hybrid, vlm and audio LM families at full width (``ModelBundle.loss``,
``ServingEngine``, and ``Trainer`` at cut depths), and the FFCz service path
(temporal streams, ``FFCzService``, session recovery).
Phases, one JSON line each (or more):

  1 device    card name, count, nvidia-smi name and power limit
  2 build     nvcc wall seconds (one process per source, in parallel)
  3 kernels   each kernel vs its twin: bitwise (Z of the forward epilogue
              within 2 ulp), CUDA-event times of kernel and twin, bound
  4 even      nyx-like-256 (256^3), szlike base: kernels 3 and 4 launch
  5 odd       the same field cropped to 256x256x255: kernels 1 and 2 launch
  6 pointwise pspec_rel (pointwise Delta) at 64^3 and an E_roi mask
              (pointwise E) at 128^3 (CUTS)
  7 golden    the three blobs in tests/data decode to their stored outputs
  quantize    repro_torch.kernels.quantize_edits on phase 4's 256^3 spatial
              edits (m = 16), scalar and pointwise bound: bitwise vs its twin
  block_transform  repro_torch.kernels.block_transform_quantize on phase 4's
              field blockified as zfplike does (262,144 x 64, DCT-4 Kronecker
              matrix, q = 2E / gain^3 at E_rel = 1e-3), at B = 128, and at
              B = 64 with 37 rows more (ragged tile, ring wrap): bitwise vs
              its twin; the TF32-off matmul + round as library; beside the
              bound the floor without FMA (bound_ms_unfused); ptxas registers
              and spills (0 spills required)
  8 lm        the flash library's SASS counts (HGMMA, TMA loads) and ptxas
              registers and spills; flash attention vs its twin (float32 atol
              3e-5; bfloat16 one ulp at each element's magnitude, 3e-5 floor)
              at d = 64 and 128 with kernel, twin and
              scaled_dot_product_attention times, and again at the families'
              forward-loss shapes ((4, 24, 8, 2048, 64), zamba2's (4, 32,
              32, 2048, 112), llava's (4, 32, 8, 4928, 128) and whisper's
              (4, 6, 6, 448, 64))
  pencils     (part kernel) the per-pencil kernels vs their twins at the KV
              shapes
  sharded     the distribution at world size 1 (one-rank NCCL group, 1-D
              DeviceMesh "data"), the code the CPU tests run on 2 and 4 gloo
              ranks: FFCz.compress(ShardedField) of nyx-like-128 (Delta_rel)
              and nyx-like (64^3, pspec_rel; CUTS) with fft_impl "packed",
              stored bounds rechecked in float64, decompress_sharded bitwise
              decompress; a pallas CorrectionEngine(backend="sharded") on
              49,152 pencils of 1024 (kernels 3p, 4p, launches on path
              "sharded", first calls held bitwise) bitwise the batched
              engine; compressed_psum of 2^26 values bitwise the one-device
              quantize-dequantize; power_spectrum of a ShardedField against
              the unsharded one (shells rtol 1e-4, DC 1e-6 of the largest).  Not shown on
              one card: more than one rank, NCCL's all-to-all across cards,
              cuFFT's batch-invariance across world sizes
  lm_family   qwen2-0.5b (24 layers), granite-moe-3b-a800m (32), mamba2-2.7b
              (64), zamba2-7b (81: 13 groups + 3), llava-next-mistral-7b (32
              layers; 2880 standard-normal patches before each row's 2048
              tokens, zero patches when served) and whisper-tiny (4 encoder
              layers over 1500 frames, 4 decoder layers at 448 tokens,
              prompts of 4-432) at full width, random weights,
              attention_impl "pallas".  float32: the loss of
              (2, 2048) tokens within 1e-4 of a second correct forward (naive
              attention; mamba2: half the SSD chunk), 4 requests' decode
              logits within max(1e-4, twice the floor between the two
              cache-less forwards) of a cache-less forward, and that bar
              missed by a decode step whose cache has its SSM states (or,
              without any, its v) zeroed.  bf16: the forward loss of 4x2048
              tokens (flash launches: one a layer, one a group for zamba2's
              shared block, one a decoder layer for whisper, none for
              mamba2) within 1e-3 of the second
              forward, a profile (idle share), ServingEngine on 8 requests
              with decode logits within 2e-2 of the floor (moe at a capacity
              where no pair drops, then at the default for tokens/s), and
              (not mamba2) KV compression of the nested cache at
              kv_Delta_rel 1e-4 through kernels 3p/4p, 4 requests a batch:
              every pencil rechecked in float64, the loop's peak memory
              over its packed batch (loop_memory_factor), the kernels'
              first calls held bitwise against the twins.  mamba2's bf16 decode and zamba2's bf16
              loss and decode are reported there and held at a check-only
              depth (CUTS): mamba2 at 48 layers, zamba2 at 12 (part
              bf16_check_depth: the loss within 1e-3; one decode step after
              an aligned prefill within 2e-2 + twice the floor, and that bar
              missed with the SSM states zeroed)
  pencils     compress_cache on the qwen2-0.5b cache of 4x2048 tokens (49,152
              pencils of 1024) with the batched engine, fft_impl "pallas"
              (kernels 3 and 4 per pencil) and "xla", and one correct call
              with block 1023 (kernels 1 and 2 per pencil): every pencil's
              bounds rechecked in float64 on the host; each call's peak
              device memory above its start over its packed batch's bytes
              (loop_memory_factor)
  train       Trainer on qwen2-0.5b at full width, 12 of 24 layers (CUTS; bf16 blocks,
              remat "dots", 4x2048 tokens a step) with FFCz gradient
              compression (grad_Delta_rel 5e-5: at the default 1e-2 the
              correction never acts), 4 steps; then raw checkpoints every 2
              steps, a failure injected at step 3, and a new Trainer that
              resumes at step 2 and ends at the uninterrupted run's loss
              (rtol 1e-4): step seconds, tokens/s, compress seconds, losses,
              peak device memory
  train_mesh  the same 12-layer qwen2-0.5b (4x2048 tokens a step) trained 2
              steps by Trainer(mesh=make_mesh((1, 1), ("data", "model"))) on
              a one-rank NCCL group: the rules' FSDP placements, the
              segment-wise step, the gradients compressed over the mesh
              through a pallas engine (kernels 3p/4p, first calls held
              bitwise): losses and every parameter bitwise a one-device
              Trainer's steps with the same engine, one ulp planted in a
              shard caught; step and compress seconds, peak memory, the
              state bytes held against the rules' share; the segments run
              under the mesh's tensor-parallel context (model size 1: every
              operator the identity).  Not shown on one card: more than one
              rank (CPU gloo tests at 2, 4 and 8 ranks, "model" axes of 2 and
              4; examples/train_mesh_torch.py on 2 and 4 cards)
  serve_mesh  qwen2-0.5b at full width and depth (bf16, attention_impl
              "pallas", random weights) served through make_step prefill
              (4 prompts of 2048 tokens) and 2 decode steps (MeshServe) on
              the one-rank (1, 1) mesh: logits bitwise the one-device
              bundle's, flash launched once a layer in the prefill (path
              "serve_mesh") and its first call held against the twin
  grad_pallas one step's gradients (315 M values) through compress_gradients
              with the pallas engine (kernels 3 and 4 per pencil) and the
              xla engine, every pencil rechecked in float64 on the host
  (both)      grad_pallas and checkpoint also replay the first call of
              kernels 3 and 4 at each pencil length they run against the
              twins (bitwise)
  checkpoint  CheckpointManager + CheckpointCodec(enabled=True, pallas
              engine) on a trained (params, opt_state) of whisper-tiny at
              full width and depth (4 + 4 layers, 4 x 448 tokens a step;
              in place of qwen2-0.5b at 2 layers, CUTS); a new Trainer
              restores it (B leaves within their stored E and Delta in
              float64, R leaves bitwise) and steps
  train_family  Trainer on granite-moe-3b-a800m (8 of 32 layers), mamba2-2.7b
              (16 of 64), zamba2-7b (12 of 81: two groups, the shared block
              called twice), llava-next-mistral-7b (4 of 32; 2 rows of 2880
              patches + 2048 tokens) and whisper-tiny (4 + 4) at full width
              (CUTS; bf16 blocks, remat "dots", xla_flash, 4x2048 tokens,
              whisper 4x(1500 frames + 448 tokens)), FFCz gradient
              compression at grad_Delta_rel 5e-5 through a pallas engine
              (3p/4p; 1p/2p for a leaf of odd length below the block, which
              none of them has), raw checkpoints: a float32 gradient check
              at 2 layers (zamba2 6: its first group), full width, every
              leaf within 1e-4 of its largest |g| of a second path (naive
              attention; mamba2 half the SSD chunk; moe at no-drop
              capacity), a zeroed leaf missing that bar; 3 timed steps (step
              seconds, tokens/s, compress seconds, more than half the
              pencils at 2+ iterations, peak memory, loop_memory_factor, the
              kernels' first calls held bitwise against the twins); then at
              a cut depth (RESUME_LAYERS, CUTS) 2 steps, a failure at step 1
              with a checkpoint every step, and a new Trainer that resumes
              there and ends within rtol 1e-4 of the uninterrupted loss
  stream_field  TemporalCodec in field mode (pallas engine) on 5 frames of
              an evolving 128^3 lognormal field (keyframe every 4, linear),
              warm start on and off (kernels 3, 4), then 3 frames cropped
              to 128x128x127 (kernels 1, 2): iterations warm against cold,
              seconds per frame by stage, every frame rechecked against the
              header's (E, Delta) in float64, every seek bitwise the
              sequential decode
  stream_eeg  pencil mode on 8 EEG frames of 128 channels x 8192 samples
              (one pencil a channel: 3p, 4p), then 3 frames at block 4095
              (1p, 2p), Delta_rel 1e-4; the same rechecks
  service     FFCzService (pallas engine, max_batch 8, block 4096, depth 2,
              file-backed session journals) on 8 fields of 1024^2 and 2 of
              128^3, 16 pencil tensors of 64 Ki - 1 Mi values, a 4-frame
              512^2 stream and a live session (4 appends, a duplicate
              retry, a finalize); every blob decoded, a quarter with a bit
              flipped; no rung allowed; p50/p99 latency, timers, counters;
              again at depth 1, byte-identical
  service_faults  the same under FaultInjector(p_codec=0.3, p_dispatch=0.3,
              p_oom=0.5, max_per_site=2, seed=7): fallback:packed,
              fallback:xla and bisect each taken, every completed result
              within its bounds
  session_recover  a session's .wal after 2 appends, recovered by a new
              FFCzService and finished: bitwise compress_stream's container
  (all five)  replay the first call of the loop's kernels at each shape
              against the twins (bitwise)
  9 summary   the kernels line, the nvidia-smi line, then {"ok": true, ...}

Any failure exits non-zero before the last line.  The script needs a CUDA
card and the repository around it: without either it exits 2 and prints no
result.

    python3 chip_smoke.py --compare-lm OTHER_CHECKOUT

runs only phase lm_family on qwen2-0.5b (float32 checks, forward loss,
profile, serving with and without KV compression) of another checkout
(one whose chip_smoke.py has phase_lm_family) and of this one, each in a
fresh process, in the order other, this, this, other, so that two trees
are compared on one card in one run.

    python3 chip_smoke.py --decode-sweep

prints the bf16 decode readings of mamba2-2.7b and zamba2-7b at several
depths that the check-only depths were chosen from.

    python3 chip_smoke.py --train-families

builds the kernels and runs phase train_family alone, with its gates.

    python3 chip_smoke.py --sharded

builds the kernels and runs phase sharded alone, with its gates.

    python3 chip_smoke.py --train-mesh

builds the kernels and runs phases train_mesh and serve_mesh alone, with
their gates.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
STARTED = time.perf_counter()

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, non-tensor FP32 FLOP/s
# and dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TENSOR_FLOP_PER_S = 989e12
# qwen2-0.5b layers of phase train (CUTS)
TRAIN_LAYERS = 12
# phase 6 runs below the 256^3 of phases 4-5: the pspec bound makes every
# frequency component an edit (~8.5M at 256^3), and the host Huffman coder
# (a byte-identical copy of the reference's) would not finish in the
# smoke's time limit
CUTS = ["phase 6's pspec_rel case at 64^3 and its E_roi case at 128^3, instead of 256^3: host Huffman "
        "coding of the dense pspec edit stream is the limit (at 128^3 the pspec case took 103 s of the "
        "script's 1200 on an NVIDIA H100 80GB HBM3 machine at 700 W, once the vlm and audio families were in)",
        f"phase train (and the gradients of phase grad_pallas) at {TRAIN_LAYERS} of 24 qwen2-0.5b layers, every "
        "width kept (a cut for time): at full depth the phase took 101 s, and with the vlm and audio families "
        "the script reached 1184 s of its 1200 on an NVIDIA H100 80GB HBM3 machine at 700 W (host stages "
        "spread ~10 % between calls)",
        "phase checkpoint on whisper-tiny at full width and depth (0.12 G values of state to compress) "
        "instead of qwen2-0.5b at 2 of 24 layers (0.47 G values; a cut for time): the base codec, float64 "
        "polish and zlib run on the host, qwen2's tied embedding is in the state three times (params, m, v), "
        "and its save took 262.8-302.7 s of the phase's 302.9-348.0 in three runs of this script on NVIDIA "
        "H100 80GB HBM3 machines at 700 W, which read 1141.7-1198.3 s of the 1200 allowed",
        "phase stream_field's frames at 128^3 instead of the 256^3 of phases 4-5 (a cut for time): a 256^3 "
        "frame costs 32-42 s of host float64 polish, and the phase encodes 13 frames",
        "phase stream_field at 5 frames a run (warm, cold) and 3 cropped, not 8 and 4, and phase stream_eeg at "
        "8 frames and 3 at block 4095, not 16 and 4 (cuts of frame counts for time): at the full counts the five "
        "service-path phases took 272 s of the 200 s they may add (on an NVIDIA H100 80GB HBM3 at 700 W), "
        "nearly all host float64 polish (0.3-8.6 s a 128^3 frame, 1.5-2 s an EEG frame)",
        "phase lm_family's bf16 gates of mamba2-2.7b at 48 of 64 layers and of zamba2-7b at 12 of 81 (2 groups, "
        "the shared block reused), every width kept: a check-only depth beside the full-depth runs, which report "
        "them (CHECK_DEPTH; the readings behind it: python3 chip_smoke.py --decode-sweep)",
        "phase train_family at 8 of 32 granite-moe-3b-a800m layers, 16 of 64 mamba2-2.7b, 12 of 81 zamba2-7b "
        "(two groups: the shared block runs twice) and 4 of 32 llava-next-mistral-7b (2 rows of 2880 patches + "
        "2048 tokens), every width kept (a cut for memory: the parameters, float32 moments, gradients and the "
        "pencil loop of a 1.0-1.4 G-parameter model fill most of the 80 GB card)",
        "phase train_family's failure-and-resume runs at 2 steps (a failure at step 1, not 3 steps and step 2) "
        "and shallower, every width kept: 2 granite-moe layers, 2 mamba2, 6 zamba2 (one group with the shared "
        "block), 1 llava, whisper whole (a cut for time: raw checkpoints moved ~0.56 GB/s on an NVIDIA H100 80GB "
        "HBM3 machine at 700 W, and at the train depths the five archs' saves and restores took 290 of the "
        "phase's 311 s against the 150 s it may add)",
        "phase sharded's pspec_rel case at 64^3 (nyx-like) instead of nyx-like-128, as phase 6's: the pspec bound "
        "makes every frequency component an edit, and the host Huffman coder took 103 s for that case at 128^3 "
        "against the phase's 40 s"]


class SmokeFailure(Exception):
    pass


def emit(phase: str, **fields) -> None:
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields, "elapsed_s": time.perf_counter() - STARTED}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn`` (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_ulp(a, b) -> int:
    """Largest distance in float32 units in the last place between a and b."""
    import torch

    ia = torch.view_as_real(a).contiguous().view(torch.int32).to(torch.int64)
    ib = torch.view_as_real(b).contiguous().view(torch.int32).to(torch.int64)
    # map the sign-magnitude bit patterns onto a monotone integer line
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(torch.max(torch.abs(ia - ib)))


def same(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


def phase_kernels(dev):
    """Each kernel against its twin at the main path's shapes; returns the
    per-kernel records of the summary line (launches filled in later)."""
    import torch

    from repro_torch.kernels.fcube import ops as fcube_ops
    from repro_torch.kernels.rfft import ops as rfft_ops
    from repro_torch.kernels.scube import ops as scube_ops

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev, dtype=torch.float32)

    even, odd = (256, 256, 256), (256, 256, 255)
    tol, slack = 1e-5, 0.5
    records = {}
    layouts = {}

    def produced(name, t):
        """Record the strides cuFFT handed back (the loop makes every
        transform output contiguous before a kernel sees it)."""
        layouts[name] = {"shape": list(t.shape), "stride": list(t.stride()),
                         "contiguous": t.is_contiguous()}
        return t.contiguous()

    def bound(case, bytes_moved, flops):
        """Add the least time the card could take for the case's work: the
        bytes each input read once and each output written once over HBM
        bandwidth, or its float32 operations over the FP32 peak."""
        t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
        case.update(bytes=bytes_moved, flops=flops, bound_ms=max(t_bytes, t_ops) * 1e3,
                    bound_by="bytes" if t_bytes >= t_ops else "operations")
        return case

    def record(name, source, replaces, cases):
        # the summary line carries the scalar-bound case: the bound kind of
        # the main path's Delta_rel runs (phases 4 and 5)
        main = cases[0]
        records[name] = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
        }
        emit("kernels", kernel=name, cases=cases)

    # row 1: s-cube on the odd-axis fallback's field, scalar and pointwise E
    x = randn(odd)
    cases = []
    for label, E in (("scalar", 1.0), ("pointwise", uniform(odd, 0.5, 1.5))):
        got = scube_ops.project_scube_fused(x, E)
        want = scube_ops.project_scube_plain(x, E)
        require(all(same(g, w) for g, w in zip(got, want)), f"scube {label}: kernel != twin")
        n = x.numel()
        cases.append(bound({
            "bound": label, "bitwise": True, "max_abs_err": 0.0,
            "ms": cuda_time_ms(lambda: scube_ops.project_scube_fused(x, E)),
            "plain_ms": cuda_time_ms(lambda: scube_ops.project_scube_plain(x, E)),
        }, bytes_moved=4 * n + (4 * n if label == "pointwise" else 4) + 8 * n, flops=3 * n))
    record("scube", "src/repro_torch/csrc/scube.cu", "src/repro/kernels/scube/kernel.py:19", cases)

    # row 2: f-cube + count on the odd field's half-spectrum (256x256x128)
    delta = produced("rfftn 256x256x255", torch.fft.rfftn(randn(odd)))
    d_scalar = float(delta.real.std())
    cases = []
    for label, D in (("scalar", d_scalar), ("pointwise", uniform(delta.shape, 0.5, 1.5) * d_scalar)):
        got = fcube_ops.project_fcube_fused(delta, D, n_last=odd[-1], check_tol=tol, check_slack=slack)
        want = fcube_ops.project_fcube_plain(delta, D, n_last=odd[-1], check_tol=tol, check_slack=slack)
        require(all(same(g, w) for g, w in zip(got, want)), f"fcube {label}: kernel != twin")
        require(0 < int(got[2]) < 2 * delta.numel(), f"fcube {label}: degenerate count {int(got[2])}")
        n = delta.numel()
        cases.append(bound({
            "bound": label, "bitwise": True, "violations": int(got[2]), "max_abs_err": 0.0,
            "ms": cuda_time_ms(lambda: fcube_ops.project_fcube_fused(
                delta, D, n_last=odd[-1], check_tol=tol, check_slack=slack)),
            "plain_ms": cuda_time_ms(lambda: fcube_ops.project_fcube_plain(
                delta, D, n_last=odd[-1], check_tol=tol, check_slack=slack)),
        }, bytes_moved=8 * n + (4 * n if label == "pointwise" else 4) + 16 * n + 4, flops=12 * n))
    record("fcube", "src/repro_torch/csrc/fcube.cu", "src/repro/kernels/fcube/kernel.py:36", cases)

    # row 3: forward epilogue on the even field's half-spectrum (256x256x129)
    delta = produced("rfftn 256x256x256", torch.fft.rfftn(randn(even)))
    d_scalar = float(delta.real.std())
    cases = []
    for label, D in (("scalar", d_scalar), ("pointwise", uniform(delta.shape, 0.5, 1.5) * d_scalar)):
        got = rfft_ops.fwd_epilogue_fused(delta, D, weighted=True, check_tol=tol, check_slack=slack)
        want = rfft_ops.fwd_epilogue_plain(delta, D, weighted=True, check_tol=tol, check_slack=slack)
        for i, part in ((0, "clipped"), (1, "displacement"), (3, "violations")):
            require(same(got[i], want[i]), f"rfft_fwd_epilogue {label}: {part} kernel != twin")
        z_bitwise = same(got[2], want[2])
        ulp = 0 if z_bitwise else max_ulp(got[2], want[2])
        require(got[2].shape == want[2].shape and ulp <= 2, f"rfft_fwd_epilogue {label}: Z off by {ulp} ulp")
        n, h = delta.numel(), delta.shape[-1]
        nz = n // h * (h - 1)  # Z covers the first Nh of the Nh + 1 columns
        cases.append(bound({
            "bound": label, "bitwise": z_bitwise, "z_max_ulp": ulp, "violations": int(got[3]),
            "max_abs_err": float(torch.max(torch.abs(got[2] - want[2]))),
            "ms": cuda_time_ms(lambda: rfft_ops.fwd_epilogue_fused(
                delta, D, weighted=True, check_tol=tol, check_slack=slack)),
            "plain_ms": cuda_time_ms(lambda: rfft_ops.fwd_epilogue_plain(
                delta, D, weighted=True, check_tol=tol, check_slack=slack)),
        }, bytes_moved=8 * n + (4 * n if label == "pointwise" else 4) + 8 * h + 16 * n + 8 * nz + 4,
            flops=12 * n + 20 * nz))
    record("rfft_fwd_epilogue", "src/repro_torch/csrc/rfft.cu",
           "src/repro/kernels/rfft/kernel.py:50", cases)

    # row 4: s-clip of the half-length ifftn output (256x256x128 complex)
    z = produced("ifftn 256x256x128",
                 torch.fft.ifftn(torch.complex(randn((256, 256, 128)), randn((256, 256, 128)))))
    produced("irfftn 256x256x255", torch.fft.irfftn(delta[..., :128], s=odd))
    e_scalar = float(z.real.std())
    cases = []
    for label, E in (("scalar", e_scalar), ("pointwise", uniform(even, 0.5, 1.5) * e_scalar)):
        got = rfft_ops.unpack_sclip_fused(z, E, even)
        want = rfft_ops.unpack_sclip_plain(z, E, even)
        require(all(same(g, w) for g, w in zip(got, want)), f"unpack_sclip {label}: kernel != twin")
        n = 2 * z.numel()
        cases.append(bound({
            "bound": label, "bitwise": True, "max_abs_err": 0.0,
            "ms": cuda_time_ms(lambda: rfft_ops.unpack_sclip_fused(z, E, even)),
            "plain_ms": cuda_time_ms(lambda: rfft_ops.unpack_sclip_plain(z, E, even)),
        }, bytes_moved=4 * n + (4 * n if label == "pointwise" else 4) + 8 * n, flops=3 * n))
    record("unpack_sclip", "src/repro_torch/csrc/scube.cu",
           "src/repro/kernels/rfft/kernel.py:151", cases)
    emit("fft_layouts", outputs=layouts)
    return records


def launch_counters():
    """Every kernel wrapper's ``launches`` dict."""
    from repro_torch.kernels.block_transform import ops as bt_ops
    from repro_torch.kernels.fcube import ops as fcube_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.quantize import ops as quantize_ops
    from repro_torch.kernels.rfft import ops as rfft_ops
    from repro_torch.kernels.scube import ops as scube_ops

    return (scube_ops.launches, fcube_ops.launches, rfft_ops.launches, flash_ops.launches,
            quantize_ops.launches, bt_ops.launches)


def without_counting(fn):
    """Run ``fn``, then put every launch count back as it was before: its
    launches (a replay against the twins) are not the path's."""
    counters = launch_counters()
    saved = [dict(c) for c in counters]
    try:
        return fn()
    finally:
        for c, kept in zip(counters, saved):
            c.update(kept)


def reset_launches():
    """Set every kernel's launch count to 0; returns a reader of the counts."""
    all_counters = launch_counters()
    for counters in all_counters:
        for k in counters:
            counters[k] = 0
    return lambda: {k: n for counters in all_counters for k, n in counters.items()}


def bf16_within_one_ulp(got, want, floor: float = 3e-5):
    """(ok, largest distance in bfloat16 ulps, elements over one ulp, largest
    magnitude among them).  ok: |got - want| <= one bfloat16 ulp of
    max(|got|, |want|) + floor at every element; the float32 bar is the floor
    because an output that cancels to near zero has a bfloat16 ulp far below
    the float32 rounding of its order-one terms."""
    import torch

    a, b = got.to(torch.float32), want.to(torch.float32)
    mag = torch.maximum(a.abs(), b.abs())
    _, e = torch.frexp(mag)  # mag in [2^(e-1), 2^e): its bfloat16 ulp is 2^(e-8)
    ulp = torch.where(mag > 0, torch.ldexp(torch.ones_like(mag), e - 8), torch.zeros_like(mag))
    diff = (a - b).abs()
    over = diff > ulp
    ulps = torch.where(ulp > 0, diff / ulp, torch.zeros_like(diff))
    worst = float(mag[over].max()) if bool(over.any()) else 0.0
    return bool((diff <= ulp + floor).all()), float(ulps.max()), int(over.sum()), worst


def causal_attention_flops(b, hq, sq, sk, d) -> int:
    """Exact FLOPs of suffix-causal attention: query i sees sk - sq + i + 1
    keys, and each (query, key) pair costs 2d for q.k and 2d for p.v."""
    pairs = sq * (sk - sq) + sq * (sq + 1) // 2
    return 4 * b * hq * d * pairs


# (label, sq, sk, head dim)
FLASH_CASES = (("prefill", 2048, 2048, 64), ("suffix", 128, 2048, 64), ("ragged", 1030, 1030, 64),
               ("prefill_d128", 2048, 2048, 128))


def ptxas_report(library, entries):
    """Per-kernel ptxas registers and spills from the build log of
    ``library`` (built with ``-Xptxas -v``): each entry function whose name
    holds one of ``entries`` (tried in order) as ``entry<N>``, N its first
    integer template argument."""
    import re

    from repro_torch.kernels import build

    kernels, name = {}, None
    for line in build.build_log(library).splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            d = re.search(r"Li(\d+)E", mangled)
            name = next((e for e in entries if e in mangled), mangled) + f"<{d.group(1) if d else '?'}>"
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and name:
            kernels.setdefault(name, {}).update(spill_stores=int(spill.group(1)),
                                                spill_loads=int(spill.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            kernels.setdefault(name, {})["registers"] = int(regs.group(1))
    return kernels


def no_spills(ptxas, count) -> bool:
    """True when ``ptxas`` reports ``count`` kernels, none of them spilling."""
    return len(ptxas) == count and all(
        k.get("spill_stores", 1) == 0 and k.get("spill_loads", 1) == 0 for k in ptxas.values())


def flash_build_report():
    """(SASS counts, per-kernel ptxas registers and spills) of the built
    flash library: HGMMA is a wgmma, UTMALDG / UBLKCP a TMA load."""
    import re

    from repro_torch.kernels import build

    sass = subprocess.run([str(Path(build.nvcc()).parent / "cuobjdump"), "-sass",
                           str(build.library_path("flash_attention"))],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UTMALDG", "UBLKCP")}
    return counts, ptxas_report("flash_attention", ("flash_fwd_sm90", "flash_fwd_kernel"))


def phase_flash(dev, heads=(4, 14, 2), lengths=FLASH_CASES):
    """The flash-attention kernel against its twin at the LM phase's shapes
    (``heads`` = (b, hq, hkv), qwen2-0.5b's at batch 4; each case of
    ``lengths`` gives sq, sk and the head dim).  Returns the summary record,
    whose main case is the first: the forward loss's (4, 14, 2048, 64)
    bfloat16 attention."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(device=dev).manual_seed(1)
    b, hq, hkv = heads
    cases = []
    for label, sq, sk, d in lengths:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)
                       for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
            got = flash_ops.flash_attention(q, k, v)
            want = attention_ref(q, k, v)
            torch.cuda.synchronize()
            err = float(torch.max(torch.abs(got.to(torch.float32) - want.to(torch.float32))))
            case = {"case": label, "dtype": str(dtype).split(".")[-1], "q": list(q.shape),
                    "kv": list(k.shape), "max_abs_err": err}
            if dtype == torch.bfloat16:
                ok, ulps, n_over, worst = bf16_within_one_ulp(got, want)
                # the split P's tensor-core floor: P.V twice (hi and lo), 1.5x the operations
                case.update(max_ulps=ulps, n_over_one_ulp=n_over, largest_value_over_one_ulp=worst,
                            bound_ms_split_p_tensor=1.5 * causal_attention_flops(b, hq, sq, sk, d)
                            / BF16_TENSOR_FLOP_PER_S * 1e3)
                require(ok, f"flash_attention {label} bf16: more than one ulp + 3e-5 from the twin")
            else:
                require(err <= 3e-5, f"flash_attention {label} f32: max |kernel - twin| {err} > 3e-5")
            flops = causal_attention_flops(b, hq, sq, sk, d)
            n_bytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
            peak = BF16_TENSOR_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
            t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
            case.update(
                flops=flops, bytes=n_bytes,
                bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_ms_fp32_cuda_cores=flops / FP32_FLOP_PER_S * 1e3,
                bound_ms_bf16_tensor=flops / BF16_TENSOR_FLOP_PER_S * 1e3,
                bound_ms_bytes=t_bytes * 1e3,
                ms=cuda_time_ms(lambda: flash_ops.flash_attention(q, k, v)),
                plain_ms=cuda_time_ms(lambda: attention_ref(q, k, v), reps=5),
                library_ms=None,
            )
            if sq == sk:
                # top-left causal alignment equals the suffix convention when sq == sk
                sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)  # noqa: E731
                case["library_ms"] = cuda_time_ms(sdpa)
                case["library_max_abs_err"] = float(torch.max(torch.abs(
                    sdpa().to(torch.float32) - want.to(torch.float32))))
            case["tflops"] = flops / (case["ms"] * 1e-3) / 1e12
            cases.append(case)
            del q, k, v, got, want
    emit("lm", part="kernel", kernel="flash_attention", cases=cases)
    main = cases[0]
    d128 = next((c for c in cases if c["dtype"] == "bfloat16" and c["q"][-1] == 128), None)
    d128_f32 = next((c for c in cases if c["dtype"] == "float32" and c["q"][-1] == 128), None)
    f32 = cases[1]  # the main case's float32 twin
    return {
        "name": "flash_attention", "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:41", "launches": 0,
        "max_abs_err": max(c["max_abs_err"] for c in cases), "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "ms_d128": d128 and d128["ms"], "library_ms_d128": d128 and d128["library_ms"],
        "ms_float32": f32["ms"], "bound_ms_float32": f32["bound_ms"], "library_ms_float32": f32["library_ms"],
        "ms_d128_float32": d128_f32 and d128_f32["ms"], "bound_ms_d128_float32": d128_f32 and d128_f32["bound_ms"],
        "library_ms_d128_float32": d128_f32 and d128_f32["library_ms"],
    }


def device_profile(fn, top=6):
    """torch.profiler over one call of ``fn``: wall and device-busy
    milliseconds, the idle share, kernel launches and the ``top`` kernels by
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernels only (device-side events), as the profiler's own table sums them
    device = {e.key: e.self_device_time_total / 1e3 for e in events
              if e.device_type == DeviceType.CUDA and not e.is_user_annotation
              and e.self_device_time_total > 0}
    busy = sum(device.values())
    ranked = sorted(device.items(), key=lambda kv: -kv[1])[:top]
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy, "idle_share": max(0.0, 1 - busy / (wall * 1e3)),
            "kernel_launches": launches, "top_device_ms": [[k[:100], v] for k, v in ranked],
            "flash_kernel_ms": sum(v for k, v in device.items() if "flash_fwd" in k)}


def profile_lm(bundle, params, batch, phase="lm", **labels):
    """Where the device time goes: torch.profiler over one forward loss and
    over 3 decode steps after a 380-token prefill of the batch's rows (4 at
    full size; a vlm's patches first, an encoder-decoder's frames encoded),
    after the counted run.  Returns the forward's profile."""
    import torch

    with torch.no_grad():
        forward = device_profile(lambda: float(bundle.loss(params, batch)))
    tokens = batch["tokens"][:, :380]
    cache = bundle.init_cache(tokens.shape[0], vision_entries(bundle.cfg) + tokens.shape[1] + 3)
    _, cache = bundle.prefill(params, {**batch, "tokens": tokens}, cache)

    def decode3():
        nonlocal cache
        for _ in range(3):
            _, cache = bundle.decode(params, tokens[:, -1:], cache)

    decode = device_profile(decode3)
    emit(phase, **labels, part="profile", forward_loss=forward, decode_3_steps=decode)
    return forward


def serve_and_check(cfg, params, requests, dev, check=True, engine=None, after_compress=None, max_batch=4):
    """Serve ``requests`` (16 new tokens each, ``max_batch`` a batch) on one engine and,
    with ``check``, hold the first request's last decode logits against
    cache-less forwards of its ``prefix``, through ``cfg`` (``want``,
    ``diff``) and through :func:`second_forward` (``floor``: how far two
    correct forwards are apart).  ``engine`` replaces the serving engine's default
    correction engine in KV compression, and ``after_compress`` (checks of
    a batch's compression) runs after each compression, outside the serving
    time.  Prefill, KV compression and decode are timed apart."""
    import torch

    from repro_torch.models.model import _logits
    from repro_torch.serving import engine as serving_engine
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    eng = ServingEngine(cfg, ServeConfig(max_batch=max_batch, max_len=1024), params=params, device=dev)
    for prompt in requests:
        eng.submit(prompt, max_new_tokens=16)
    first = eng._make_batch(eng.queue[: eng.serve.max_batch])["tokens"][0]
    seconds = {"prefill": 0.0, "decode": 0.0, "compress": 0.0, "after_compress": 0.0}
    decode_logits = []

    def timed(name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name] += time.perf_counter() - t
            if name == "decode" and len(decode_logits) < 15:  # the first batch's 15 decode steps
                decode_logits.append(out[0][0, -1].clone())
            return out
        return call

    eng._prefill, eng._decode = timed("prefill", eng._prefill), timed("decode", eng._decode)
    compress = serving_engine.compress_cache
    timed_compress = timed("compress", compress if engine is None else (
        lambda cache, comp, **kw: compress(cache, comp, **{**kw, "engine": engine})))

    def compress_then_check(*args, **kwargs):
        out = timed_compress(*args, **kwargs)
        if after_compress is not None:
            t = time.perf_counter()
            after_compress()
            seconds["after_compress"] += time.perf_counter() - t
        return out

    serving_engine.compress_cache = compress_then_check
    t0 = time.perf_counter()
    done = []
    try:
        while eng.queue:
            done += eng.step()
    finally:
        serving_engine.compress_cache = compress
    serve_s = time.perf_counter() - t0 - seconds["after_compress"]
    require(len(done) == len(requests) and all(len(r["tokens"]) == 16 for r in done),
            "serve: wrong completions")
    out = {"done": done, "tokens": sum(len(r["tokens"]) for r in done), "seconds": serve_s,
           "prefill_seconds": seconds["prefill"], "decode_seconds": seconds["decode"],
           "compress_seconds": seconds["compress"], "after_compress_seconds": seconds["after_compress"]}
    if not check:
        return out
    prefix = torch.cat([first, torch.tensor(done[0]["tokens"][:15], device=dev)])[None]
    stubs = stub_inputs(cfg, 1, dev)  # the engine's zero patches or frames
    with torch.no_grad():
        h, _ = params(prefix, cfg, **stubs)
        want = _logits(params, h[:, -1:], cfg)[0, -1].float()
        h, _ = params(prefix, second_forward(cfg), **stubs)
        other = _logits(params, h[:, -1:], cfg)[0, -1].float()
    return {**out, "prefix": prefix, "want": want,
            "diff": float(torch.max(torch.abs(decode_logits[-1].float() - want))),
            "floor": float(torch.max(torch.abs(want - other))),
            "scale": float(want[: cfg.vocab].abs().max())}


# rows of the summary's kernels line: the seven TPU kernels, rows 1-4 twice
# (whole field and per pencil)
KERNEL_ROWS = ("scube", "fcube", "rfft_fwd_epilogue", "unpack_sclip",
               "scube_rows", "fcube_rows", "rfft_fwd_epilogue_rows", "unpack_sclip_rows",
               "quantize", "block_transform", "flash_attention")


def bound_case(case, bytes_moved, flops, peak=FP32_FLOP_PER_S):
    """Add the least time the card could take: bytes (each input read once,
    each output written once) over HBM bandwidth, or operations over the
    peak of their type."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / peak
    case.update(bytes=bytes_moved, flops=flops, bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")
    return case


def kernel_record(name, source, replaces, cases, launches, library_ms=None):
    """A summary record from a phase's cases (the first is the main one)."""
    main = cases[0]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": library_ms}


def phase_quantize(dev, spat, E, m=16):
    """QuantizeEdits through ``repro_torch.kernels.quantize_edits`` on the
    main path's spatial edits (float64 on the host, cast to float32 as ENCODE
    hands them over), with the plan's scalar E and with a pointwise bound
    (E times a seeded factor in [0.5, 1.5], an eighth of it 0): both driven
    once with the counts zeroed, then held bitwise against the twin."""
    import numpy as np
    import torch

    import repro_torch.kernels as kernels
    from repro_torch.kernels.quantize.ref import quantize_edits_ref

    v = torch.from_numpy(np.asarray(spat, np.float32)).to(dev)
    rng = np.random.default_rng(0)
    grid = (rng.uniform(0.5, 1.5, v.shape) * E).astype(np.float32)
    grid.reshape(-1)[::8] = 0.0
    bounds = (("scalar", float(E)), ("pointwise", torch.from_numpy(grid).to(dev)))
    read = reset_launches()
    outs = [kernels.quantize_edits(v, b, m=m) for _, b in bounds]
    torch.cuda.synchronize()
    launches = read()["quantize"]
    cases = []
    for (label, b), got in zip(bounds, outs):
        want = quantize_edits_ref(v, b, m)
        require(all(same(g, w) for g, w in zip(got, want)), f"quantize {label}: kernel != twin")
        n = v.numel()
        cases.append(bound_case({
            "bound": label, "shape": list(v.shape), "m": m, "bitwise": True, "max_abs_err": 0.0,
            "nonzero_codes": int(got[1].sum()), "max_abs_code": int(torch.abs(got[0]).max()),
            "ms": cuda_time_ms(lambda: kernels.quantize_edits(v, b, m=m)),
            "plain_ms": cuda_time_ms(lambda: quantize_edits_ref(v, b, m)),
        }, bytes_moved=4 * n + (4 * n if label == "pointwise" else 4) + 8 * n, flops=3 * n))
    emit("quantize", launches=launches, cases=cases)
    require(launches == len(bounds), f"quantize: {launches} launches, want {len(bounds)}")
    return kernel_record("quantize", "src/repro_torch/csrc/quantize.cu",
                         "src/repro/kernels/quantize/kernel.py:19", cases, launches)


def phase_block_transform(dev, x, E_rel=1e-3):
    """The zfplike block transform through
    ``repro_torch.kernels.block_transform_quantize``: ``x`` padded and
    blockified as ``compressors/zfplike.py`` does (4^3 blocks, B = 64), the
    DCT-4 matrix Kronecker-expanded, q = 2E / gain^3; then B = 128 at the same
    row count (each block beside its neighbour, the matrix paired with a
    2-point Haar step); then B = 64 at 37 rows more (a ragged last tile, the
    ring wrapping on every SM).  Kernel vs twin bitwise; the TF32-off matmul
    + round as library, with the count of codes that differ from it.  Each
    case carries, beside the function's bound, ``bound_ms_unfused``: the
    floor of a kernel that may not contract a product into an FMA (one
    float32 instruction per flop).  The library's ptxas report: 0 spills in
    all four instantiations."""
    import numpy as np
    import torch

    import repro_torch.kernels as kernels
    from repro_torch.compressors.zfplike import ZFPLikeCompressor
    from repro_torch.kernels.block_transform.ref import block_transform_quantize_ref

    zfp = ZFPLikeCompressor()
    padded, _ = zfp._pad(np.asarray(x, np.float32))
    b64 = torch.from_numpy(np.ascontiguousarray(zfp._blockify(padded).reshape(-1, 64))).to(dev)
    m1 = zfp._fwd
    m64 = np.kron(m1, np.kron(m1, m1))
    m128 = np.kron(np.array([[1.0, 1.0], [1.0, -1.0]]) / np.sqrt(2.0), m64)
    E = E_rel * float(np.ptp(x))
    q = 2.0 * E / zfp._gain1**3
    runs = (("zfplike 4^3", b64, m64), ("B=128", torch.cat([b64, torch.roll(b64, 1, 0)], 1).contiguous(), m128),
            ("zfplike 4^3 + 37 rows", torch.cat([b64, b64[:37]]).contiguous(), m64))
    runs = [(label, blocks, torch.from_numpy(mat.astype(np.float32)).to(dev)) for label, blocks, mat in runs]
    read = reset_launches()
    outs = [kernels.block_transform_quantize(blocks, mat, q) for _, blocks, mat in runs]
    torch.cuda.synchronize()
    launches = read()["block_transform"]
    qt = torch.tensor(q, dtype=torch.float32, device=dev)

    def library(blocks, mat):
        return torch.round(torch.matmul(blocks, mat.T) / qt).to(torch.int32)

    cases = []
    for (label, blocks, mat), got in zip(runs, outs):
        want = block_transform_quantize_ref(blocks, mat, q)
        require(same(got, want), f"block_transform {label}: kernel != twin")
        lib_diff = (got.to(torch.int64) - library(blocks, mat).to(torch.int64)).abs()
        nb, B = blocks.shape
        cases.append(bound_case({
            "case": label, "shape": [nb, B], "q": q, "bitwise": True, "max_abs_err": 0.0,
            "codes_differing_from_library": int((lib_diff > 0).sum()),
            "max_abs_diff_from_library": int(lib_diff.max()),
            "ms": cuda_time_ms(lambda: kernels.block_transform_quantize(blocks, mat, q)),
            "plain_ms": cuda_time_ms(lambda: block_transform_quantize_ref(blocks, mat, q), reps=3, warmup=1),
            "library_ms": cuda_time_ms(lambda: library(blocks, mat)),
        }, bytes_moved=4 * nb * B + 4 * B * B + 4 * nb * B, flops=2 * nb * B * B))
        cases[-1]["bound_ms_unfused"] = max(cases[-1]["bytes"] / HBM_BYTES_PER_S,
                                            2 * cases[-1]["flops"] / FP32_FLOP_PER_S) * 1e3
    ptxas = ptxas_report("block_transform", ("block_transform_kernel",))
    emit("block_transform", launches=launches, cases=cases, ptxas=ptxas)
    require(launches == len(runs), f"block_transform: {launches} launches, want {len(runs)}")
    require(no_spills(ptxas, 4), f"block_transform: ptxas reports spills or misses a kernel: {ptxas}")
    return {**kernel_record("block_transform", "src/repro_torch/csrc/block_transform.cu",
                            "src/repro/kernels/block_transform/kernel.py:23", cases, launches,
                            library_ms=cases[0]["library_ms"]),
            "ms_b128": cases[1]["ms"], "library_ms_b128": cases[1]["library_ms"]}


def phase_pencil_kernels(dev, rows=49152, block=1024):
    """The per-pencil modes of kernels 1-4 against their twins at the KV
    shapes: ``rows`` pencils of ``block`` (even: kernels 3, 4) and of
    ``block - 1`` (odd: kernels 1, 2), one bound per row."""
    import torch

    from repro_torch.kernels.fcube import ops as fcube_ops
    from repro_torch.kernels.rfft import ops as rfft_ops
    from repro_torch.kernels.scube import ops as scube_ops

    gen = torch.Generator(device=dev).manual_seed(3)
    tol = 1e-5
    odd = block - 1

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    def per_row(scale):
        return (0.5 + torch.rand((rows, 1), generator=gen, device=dev)) * scale

    records = {}

    def add(name, source, replaces, case, n_bytes, flops):
        case = bound_case(case, n_bytes, flops)
        emit("pencils", part="kernel", kernel=name, case=case)
        records[name] = kernel_record(name, source, replaces, [case], 0)

    x = randn(rows, odd)
    E = per_row(1.0)
    got, want = scube_ops.project_scube_fused(x, E), scube_ops.project_scube_plain(x, E)
    require(all(same(g, w) for g, w in zip(got, want)), "scube per pencil: kernel != twin")
    n = x.numel()
    add("scube_rows", "src/repro_torch/csrc/scube.cu", "src/repro/kernels/scube/kernel.py:19",
        {"shape": [rows, odd], "bitwise": True, "max_abs_err": 0.0,
         "ms": cuda_time_ms(lambda: scube_ops.project_scube_fused(x, E)),
         "plain_ms": cuda_time_ms(lambda: scube_ops.project_scube_plain(x, E))},
        4 * n + 4 * rows + 8 * n, 3 * n)

    delta = torch.fft.rfft(randn(rows, odd), dim=-1).contiguous()
    D = per_row(float(delta.real.std()))
    kw = dict(n_last=odd, check_tol=tol, per_row=True)
    got, want = fcube_ops.project_fcube_fused(delta, D, **kw), fcube_ops.project_fcube_plain(delta, D, **kw)
    require(all(same(g, w) for g, w in zip(got, want)), "fcube per pencil: kernel != twin")
    n = delta.numel()
    add("fcube_rows", "src/repro_torch/csrc/fcube.cu", "src/repro/kernels/fcube/kernel.py:36",
        {"shape": list(delta.shape), "bitwise": True, "max_abs_err": 0.0, "violations": int(got[2].sum()),
         "ms": cuda_time_ms(lambda: fcube_ops.project_fcube_fused(delta, D, **kw)),
         "plain_ms": cuda_time_ms(lambda: fcube_ops.project_fcube_plain(delta, D, **kw))},
        8 * n + 4 * rows + 16 * n + 4 * rows, 12 * n)

    delta = torch.fft.rfft(randn(rows, block), dim=-1).contiguous()
    D = per_row(float(delta.real.std()))
    kw = dict(weighted=True, check_tol=tol, per_row=True)
    got, want = rfft_ops.fwd_epilogue_fused(delta, D, **kw), rfft_ops.fwd_epilogue_plain(delta, D, **kw)
    require(all(same(g, w) for g, w in zip(got, want)), "rfft_fwd_epilogue per pencil: kernel != twin")
    n, h = delta.numel(), delta.shape[-1]
    nz = rows * (h - 1)
    add("rfft_fwd_epilogue_rows", "src/repro_torch/csrc/rfft.cu", "src/repro/kernels/rfft/kernel.py:50",
        {"shape": list(delta.shape), "bitwise": True, "max_abs_err": 0.0, "violations": int(got[3].sum()),
         "ms": cuda_time_ms(lambda: rfft_ops.fwd_epilogue_fused(delta, D, **kw)),
         "plain_ms": cuda_time_ms(lambda: rfft_ops.fwd_epilogue_plain(delta, D, **kw))},
        8 * n + 4 * rows + 8 * h + 16 * n + 8 * nz + 4 * rows, 12 * n + 20 * nz)

    z = torch.fft.ifft(got[2], dim=-1).contiguous()
    E = per_row(float(z.real.std()))
    got = rfft_ops.unpack_sclip_fused(z, E, (rows, block))
    want = rfft_ops.unpack_sclip_plain(z, E, (rows, block))
    require(all(same(g, w) for g, w in zip(got, want)), "unpack_sclip per pencil: kernel != twin")
    n = 2 * z.numel()
    add("unpack_sclip_rows", "src/repro_torch/csrc/scube.cu", "src/repro/kernels/rfft/kernel.py:151",
        {"shape": [rows, block], "bitwise": True, "max_abs_err": 0.0,
         "ms": cuda_time_ms(lambda: rfft_ops.unpack_sclip_fused(z, E, (rows, block))),
         "plain_ms": cuda_time_ms(lambda: rfft_ops.unpack_sclip_plain(z, E, (rows, block)))},
        4 * n + 4 * rows + 8 * n, 3 * n)
    return records


def recheck_pencils(errs, Es, Ds, corrected, block):
    """Float64 host recheck of a ``correct`` call's corrected errors: every
    value within its tensor's E (exactly: the loop's last s-clip is a clip to
    the float32 E), and every full pencil's spectrum within Delta * (1 + 1e-5)
    + tau — the loop's float32 convergence test plus tau = 5 * 2^-24 *
    log2(N) * sqrt(N) * ||pencil||_2, a bound on the float32 FFT's rounding
    (Higham, Accuracy and Stability of Numerical Algorithms, Thm 24.2).
    The tensors are rechecked in the port's host threads (numpy releases
    the interpreter lock).  Returns (worst |x| / E, worst spectrum / Delta)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from repro_torch import host

    def one(item):
        E, D, c = item
        E, D = float(E), float(D)
        x = c.detach().cpu().numpy().astype(np.float64).reshape(-1)
        peak = float(np.abs(x).max())
        mag, tau = pencil_spectra(x, block, threads=1)
        worst = float((mag / D).max()) if mag.size else 0.0
        return E, D, peak, worst, bool(np.all(mag <= D * (1 + 1e-5) + tau))

    worst_s = worst_f = 0.0
    with ThreadPoolExecutor(host.THREADS) as pool:
        for E, D, peak, worst, within in pool.map(one, zip(Es, Ds, corrected)):
            worst_s, worst_f = max(worst_s, peak / E), max(worst_f, worst)
            require(peak <= E, f"pencils: a corrected error exceeds E={E}")
            require(within, f"pencils: a pencil's spectrum exceeds Delta={D}")
    return worst_s, worst_f


def record_correct(engine, held=lambda: 0):
    """Record each ``engine.correct`` call, as (errs, Es, Ds, (corrected,
    stats), block, loop memory factor), in the returned list until the
    returned function is called.  The factor is the call's peak device
    memory above what was allocated when it began, over the bytes of its
    packed (pencils, block) float32 batch (:func:`loop_memory`, ``held``
    as there)."""
    from repro_torch.core.engine import CorrectionEngine

    calls = []
    measured, factors = loop_memory(CorrectionEngine.correct, held)

    def recording(errs, Es, Ds, **kw):
        out = measured(engine, errs, Es, Ds, **kw)
        calls.append((errs, Es, Ds, out, kw["block"], factors.pop()[1]))
        return out

    engine.correct = recording
    return calls, lambda: delattr(engine, "correct")


def recheck_calls(path, calls):
    """:func:`recheck_pencils` over calls that :func:`record_correct` kept,
    each of which must have converged: their blocks, values, pencils,
    iteration histogram, worst ratios to E and Delta and the largest loop
    memory factor."""
    import numpy as np

    out = {"blocks": [], "values": 0, "pencils": 0, "iterations_histogram": {},
           "worst_abs_over_E": 0.0, "worst_spectrum_over_Delta": 0.0, "loop_memory_factor": 0.0}
    hist = out["iterations_histogram"]
    for errs, Es, Ds, (corrected, stats), blk, factor in calls:
        out["loop_memory_factor"] = max(out["loop_memory_factor"], factor)
        require(bool(stats.converged.all()), f"{path}: a pencil did not converge")
        s, f = recheck_pencils(errs, Es, Ds, corrected, blk)
        out["worst_abs_over_E"] = max(out["worst_abs_over_E"], s)
        out["worst_spectrum_over_Delta"] = max(out["worst_spectrum_over_Delta"], f)
        iters = stats.block_iterations.cpu().numpy()
        for k, v in zip(*np.unique(iters, return_counts=True)):
            hist[int(k)] = hist.get(int(k), 0) + int(v)
        out["blocks"].append(blk)
        out["values"] += sum(e.numel() for e in errs)
        out["pencils"] += int(iters.size)
    return out


def pencil_spectra(x, block, threads=None):
    """For each full ``block``-pencil of the flat float64 ``x``: the largest
    |Re| or |Im| of its rfft, and tau = 5 * 2^-24 * log2(N) * sqrt(N) *
    ||pencil||_2.  Rows are split among ``threads`` host threads (default
    the port's; numpy's FFTs release the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from repro_torch import host

    full = x[: x.size // block * block].reshape(-1, block)

    def part(rows):
        spec = np.fft.rfft(rows, axis=-1)
        mag = np.maximum(np.abs(spec.real), np.abs(spec.imag)).max(axis=1)
        return mag, 5 * 2.0**-24 * np.log2(block) * np.sqrt(block) * np.sqrt((rows * rows).sum(axis=1))

    chunks = np.array_split(full, max(1, min(threads or host.THREADS, len(full) // 256)))
    if len(chunks) == 1:
        parts = [part(chunks[0])]
    else:
        with ThreadPoolExecutor(len(chunks)) as pool:
            parts = list(pool.map(part, chunks))
    return np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts])


def phase_pencils(dev, records, cfg, params, tokens=(4, 2048), block=1024, kv_Delta_rel=1e-4):
    """KV-cache compression of the full-width cache: prefill ``tokens`` with
    ``params``, then ``compress_cache`` with the batched engine and fft_impl
    "pallas" (kernels 3, 4 per pencil) and "xla", and one ``correct`` call on
    the same quantization errors with an odd block (kernels 1, 2 per pencil).
    ``kv_Delta_rel`` is tight enough that the loop corrects (at the default
    1e-2 every pencil is inside both cubes at the first check).  Each run's
    corrected errors are rechecked in float64 on the host.  Wall seconds are
    of the second call of each run (the first builds cuFFT plans)."""
    import dataclasses

    import torch

    from repro_torch.core.engine import CorrectionEngine
    from repro_torch.models.model import build_model
    from repro_torch.serving.kv_compress import compress_cache

    bundle = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab, tokens, generator=gen, device=dev)}
    cache = bundle.init_cache(tokens[0], tokens[1])
    _, cache = bundle.prefill(params, batch, cache)
    comp = dataclasses.replace(cfg.compression, kv_cache_compression=True, kv_Delta_rel=kv_Delta_rel)

    def run(label, engine, call):
        call(engine)  # warm-up: cuFFT plans for this run's shapes
        torch.cuda.synchronize()
        calls, stop = record_correct(engine)
        read = reset_launches()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = call(engine)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            stop()
        counts = read()
        require(len(calls) == 1, f"pencils {label}: {len(calls)} correct calls, want 1")
        rechecked = recheck_calls(f"pencils {label}", calls)
        (errs, Es, _, _, blk, _), = calls
        case = {"case": label, "fft_impl": engine.fft_impl, "backend": engine.backend, "block": blk,
                "values": rechecked["values"], "pencils": rechecked["pencils"], "seconds": seconds,
                "iterations_histogram": rechecked["iterations_histogram"], "converged": True,
                "worst_abs_over_E": rechecked["worst_abs_over_E"],
                "worst_spectrum_over_Delta": rechecked["worst_spectrum_over_Delta"],
                "loop_memory_factor": rechecked["loop_memory_factor"],
                "launches": {k: v for k, v in counts.items() if v}}
        return case, counts, result, errs, Es

    pallas = CorrectionEngine(backend="batched", fft_impl="pallas", device=dev)
    case, counts, out, errs, Es = run("compress_cache pallas", pallas,
                                      lambda eng: compress_cache(cache, comp, block=block, engine=eng))
    # what the bf16 store adds on top of the float32 guarantee (reported only)
    worst = 0.0
    for j, name in enumerate(("k", "v")):
        err = (out[name].float() - cache[name].float()).abs().amax(dim=(1, 2, 3, 4))
        worst = max(worst, float((err / torch.stack(Es[j * cfg.n_layers:(j + 1) * cfg.n_layers])).max()))
    case["bf16_store_worst_abs_over_E"] = worst
    emit("pencils", **case)
    launches_on_path(records, counts, "pencils")
    del out

    case, counts, _, _, _ = run("compress_cache xla", CorrectionEngine(backend="batched", device=dev),
                                lambda eng: compress_cache(cache, comp, block=block, engine=eng))
    emit("pencils", **case)

    odd = block - 1
    Ds = [torch.tensor(comp.kv_Delta_rel * odd, dtype=torch.float32, device=dev) * E for E in Es]
    case, counts, _, _, _ = run(f"correct block {odd} pallas", pallas,
                                lambda eng: eng.correct(errs, Es, Ds, block=odd, max_iters=8))
    emit("pencils", **case)
    launches_on_path(records, counts, "pencils", ("fcube_rows", "scube_rows"))
    del errs, cache


# the LM families at full width, qwen2-0.5b (dense) first: phase pencils
# compresses the cache its params give
FAMILIES = ("qwen2-0.5b", "granite-moe-3b-a800m", "mamba2-2.7b", "zamba2-7b", "llava-next-mistral-7b",
            "whisper-tiny")
# phase_lm_family's (tokens, prompts) where they are not (4, 2048) and (4,
# 600): whisper's decoder context is 448 tokens (16 of them served)
LM_SHAPES = {"whisper-tiny": ((4, 448), (4, 432))}
# arch: (layers, gates).  In bf16 the random-weight mamba2 and zamba2
# stacks carry one rounding, through the layers, into logit differences
# that grow with depth to the logits' own order; at full depth their served
# decode (and zamba2's loss, ``gates``) is reported, not held.  Both bf16
# gates are held at ``layers`` (listed in CUTS): deep enough that a zeroed
# SSM state moves the logits (at 4-8 mamba2 layers it does not), shallow
# enough that the floor is a fraction of the logits (lm_check_depth)
CHECK_DEPTH = {"mamba2-2.7b": (48, ("decode",)), "zamba2-7b": (12, ("loss", "decode"))}
# the flash kernel at the families' attention shapes: (label, (b, hq, hkv), sq, sk, head dim)
# (llava: 2880 patches + 2048 tokens, 38.5 tiles of 128 rows; whisper's
# decoder at its 448-token context, 3.5 tiles)
FAMILY_FLASH_CASES = (("granite_moe", (4, 24, 8), 2048, 2048, 64), ("zamba2_d112", (4, 32, 32), 2048, 2048, 112),
                      ("llava", (4, 32, 8), 4928, 4928, 128), ("whisper", (4, 6, 6), 448, 448, 64))


def phase_flash_families(dev, record, cases=FAMILY_FLASH_CASES):
    """The flash kernel against its twin at the families' forward-loss
    shapes (phase_flash's bars, both dtypes): head dim 112 is zamba2-7b's.
    Adds each case's bf16 and float32 times, bound and SDPA time to the
    flash record under ``by_shape``."""
    for label, heads, sq, sk, d in cases:
        r = phase_flash(dev, heads=heads, lengths=((label, sq, sk, d),))
        record["max_abs_err"] = max(record["max_abs_err"], r["max_abs_err"])
        record.setdefault("by_shape", {})[label] = {k: r[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "ms_float32", "bound_ms_float32",
            "library_ms_float32")}


def family_layers(cfg):
    """Causal attention layers on a family's cache-less forward (the flash
    kernel's launches): every layer of a dense, vlm or moe model, the shared
    block once a group of the hybrid, none in mamba2, every decoder layer of
    whisper (its encoder and cross-attention are not causal: naive)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return 0 if cfg.family == "ssm" else cfg.n_layers


def lm_requests(cfg, prompts):
    """8 requests of ``prompts[0]``-``prompts[1]`` tokens from seed 0: their
    lengths and tokens."""
    import numpy as np

    rng = np.random.default_rng(0)
    lengths = [int(n) for n in rng.integers(prompts[0], prompts[1] + 1, 8)]
    return lengths, [rng.integers(0, cfg.vocab, n) for n in lengths]


def vision_entries(cfg):
    """Cache entries a prefill writes before the prompt's: a vlm's patches."""
    return cfg.vision_tokens if cfg.family == "vlm" else 0


def stub_inputs(cfg, rows, dev, gen=None):
    """The family's stub frontend output for ``rows`` rows (a vlm's
    ``patches``, an encoder-decoder's ``frames``): standard normal from
    ``gen``, as the token pipeline draws them, or without ``gen`` zeros, as
    the serving engine gives them; nothing for the other families."""
    import torch

    from repro_torch.models.model import STUB_INPUTS

    key = STUB_INPUTS.get(cfg.family)
    if key is None:
        return {}
    shape = (rows, cfg.vision_tokens, cfg.vision_dim) if cfg.family == "vlm" else (rows, cfg.encoder_seq, cfg.d_model)
    if gen is None:
        return {key: torch.zeros(shape, device=dev)}
    return {key: torch.randn(shape, generator=gen, device=dev)}


def lm_batch(cfg, shape, gen, dev):
    """A scoring batch: ``shape`` random tokens and the family's stubs."""
    import torch

    tokens = torch.randint(0, cfg.vocab, shape, generator=gen, device=dev)
    return {"tokens": tokens, **stub_inputs(cfg, shape[0], dev, gen)}


def second_forward(cfg):
    """The second correct forward a family's gates hold it against: naive
    attention, or for the attention-free ssm the chunked scan at half the
    chunk (its output must not depend on the chunking)."""
    import dataclasses

    if cfg.family == "ssm":
        return dataclasses.replace(cfg, ssm_chunk=cfg.ssm_chunk // 2)
    return dataclasses.replace(cfg, attention_impl="naive")


def no_drop(cfg):
    """``cfg``, for moe at capacity_factor = n_experts / top_k, where the
    capacity holds every token and no pair drops: at the default factor
    prefill, decode and a one-row forward route different token counts and
    drop differently."""
    import dataclasses

    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k) if cfg.family == "moe" else cfg


def score(cfg, params, batch, dev):
    """The forward loss of ``batch`` after a warm-up (cuBLAS handles, the
    kernels' libraries), its seconds and the kernels' launches, and the loss
    of :func:`second_forward`.  No autograd graph: the flash kernel has no
    backward."""
    import numpy as np
    import torch

    from repro_torch.models.model import build_model

    with torch.no_grad():
        bundle = build_model(cfg, device=dev)
        float(bundle.loss(params, batch))
        read = reset_launches()
        t0 = time.perf_counter()
        loss = float(bundle.loss(params, batch))  # float() waits for the device
        seconds = time.perf_counter() - t0
        counts = read()
        other = float(build_model(second_forward(cfg), device=dev).loss(params, batch))
    require(np.isfinite(loss) and np.isfinite(other), f"{cfg.name}: loss is not finite")
    return {"loss": loss, "loss_other": other, "rel_diff": abs(loss - other) / abs(other),
            "forward_seconds": seconds}, counts


def zero_leaves(tree, name):
    """Zero, in place, every tensor of the nested dict ``tree`` keyed ``name``."""
    for key, value in tree.items():
        if isinstance(value, dict):
            zero_leaves(value, name)
        elif key == name:
            value.zero_()


def cache_fault(cfg, params, served, dev):
    """A planted cache fault against the decode gate: the prefix that
    :func:`serve_and_check` held (``served``) prefilled but its last token,
    every cache leaf ``state`` (the SSM states) or, in a model without one,
    ``v`` zeroed, then one decode step.  Returns the leaf and the largest
    distance of the step's logits from the cache-less forward's, without
    the fault and with it."""
    import torch

    from repro_torch.models.model import build_model

    bundle = build_model(cfg, device=dev)
    prefix, leaf = served["prefix"], "state" if cfg.family in ("ssm", "hybrid") else "v"
    diffs = []
    for fault in (False, True):
        cache = bundle.init_cache(1, vision_entries(cfg) + prefix.shape[1])
        _, cache = bundle.prefill(params, {"tokens": prefix[:, :-1], **stub_inputs(cfg, 1, dev)}, cache)
        if fault:
            zero_leaves(cache, leaf)
        logits, _ = bundle.decode(params, prefix[:, -1:], cache)
        diffs.append(float(torch.max(torch.abs(logits[0, -1].float() - served["want"]))))
    return leaf, diffs[0], diffs[1]


def lm_float32(dev, cfg, phase, tokens, requests):
    """``cfg`` in float32 (for moe at :func:`no_drop`'s capacity), weights
    from seed 0: the loss of (2, ``tokens[1]``) tokens within 1e-4 of the
    second forward's; one batch of 4 requests' decode logits within
    max(1e-4, twice the floor between the two cache-less forwards) of a
    cache-less forward; and a planted cache fault (:func:`cache_fault`),
    which must miss that bar."""
    import dataclasses

    import torch

    from repro_torch.models.model import build_model

    cfg32 = dataclasses.replace(no_drop(cfg), dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = build_model(cfg32, device=dev).init(gen)
    batch = lm_batch(cfg, (2, tokens[1]), gen, dev)
    scored, _ = score(cfg32, params, batch, dev)
    served = serve_and_check(cfg32, params, requests[:4], dev)
    bar = max(1e-4, 2 * served["floor"])
    leaf, clean, faulty = cache_fault(cfg32, params, served, dev)
    del params
    torch.cuda.empty_cache()
    emit("lm_family", **phase, part="float32", tokens=list(batch["tokens"].shape), **scored,
         decode_vs_cacheless_max_abs=served["diff"], cacheless_floor_max_abs=served["floor"], bar=bar,
         logit_scale=served["scale"], planted_fault=f"zeroed {leaf}", fault_free_step_max_abs=clean,
         faulty_step_max_abs=faulty)
    require(scored["rel_diff"] <= 1e-4, f"{cfg.name}: float32 loss {scored['loss']} and the second forward's "
            f"{scored['loss_other']} differ by {scored['rel_diff']:.2e} > 1e-4")
    require(served["diff"] <= bar, f"{cfg.name}: float32 decode logits differ from a cache-less forward by "
            f"{served['diff']} > {bar} (1e-4 or twice the floor)")
    require(faulty > bar, f"{cfg.name}: decode with its {leaf} leaves zeroed is within the bar ({faulty} <= {bar})")
    return {"float32_loss_rel": scored["rel_diff"], "float32_decode_diff": served["diff"],
            "float32_decode_bar": bar, "float32_faulty_decode_diff": faulty}


def lm_check_depth(dev, arch, cfg, phase, tokens, requests):
    """The bf16 gates of ``arch`` at its CHECK_DEPTH layers (``cfg``'s widths,
    weights from seed 0): the loss of ``tokens`` within 1e-3 of the second
    forward's; one decode step after a prefill of the first request's
    prefix but its last token (:func:`cache_fault`: the prefill's chunks
    align with the forward's, so the drift of 15 served steps is left out)
    within 2e-2 + twice the floor between the two cache-less forwards of
    that prefix, and the same step with the SSM states zeroed beyond that
    bar.  The served decode logits are reported."""
    import dataclasses

    import torch

    from repro_torch.models.model import build_model

    cut = dataclasses.replace(cfg, n_layers=min(CHECK_DEPTH[arch][0], cfg.n_layers))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = build_model(cut, device=dev).init(gen)
    batch = lm_batch(cut, tokens, gen, dev)
    scored, _ = score(cut, params, batch, dev)
    served = serve_and_check(cut, params, requests, dev)
    leaf, clean, faulty = cache_fault(cut, params, served, dev)
    del params
    torch.cuda.empty_cache()
    bar = 2e-2 + 2 * served["floor"]
    emit("lm_family", **phase, part="bf16_check_depth", check_layers=cut.n_layers, tokens=list(tokens), **scored,
         decode_vs_cacheless_max_abs=served["diff"], cacheless_floor_max_abs=served["floor"], bar=bar,
         logit_scale=served["scale"], planted_fault=f"zeroed {leaf}", fault_free_step_max_abs=clean,
         faulty_step_max_abs=faulty)
    where = f"{arch} at {cut.n_layers} layers"
    require(scored["rel_diff"] <= 1e-3, f"{where}: loss {scored['loss']} and the second forward's "
            f"{scored['loss_other']} differ by {scored['rel_diff']:.2e} > 1e-3")
    require(clean <= bar, f"{where}: a bf16 decode step differs from a cache-less forward by {clean} > {bar} "
            f"(2e-2 + twice the floor)")
    require(faulty > bar, f"{where}: the decode step with its {leaf} leaves zeroed is within the bar "
            f"({faulty} <= {bar})")
    return {"check_layers": cut.n_layers, "check_loss_rel": scored["rel_diff"], "check_decode_step_diff": clean,
            "check_decode_bar": bar, "check_faulty_step_diff": faulty}


def phase_lm_family(dev, records, arch, cfg=None, tokens=(4, 2048), prompts=(4, 600), kv_Delta_rel=1e-4):
    """One LM family at full width (``cfg`` None: ``arch``'s published
    config), random weights from seed 0, ``attention_impl="pallas"``:

      float32  :func:`lm_float32`: the loss, decode and planted-fault gates
      bf16_check_depth  (CHECK_DEPTH's archs) :func:`lm_check_depth`
      loss   bf16: the forward loss of a ``tokens`` batch (with a vlm's
             patches or an encoder-decoder's frames, standard normal), the
             flash kernel's launches counted (one a causal attention layer), against
             the second correct forward within 1e-3; then torch.profiler
             over one forward and 3 decode steps (idle share)
      serve  ServingEngine on 8 requests (prompts of ``prompts`` tokens, 16
             new each, 4 a batch), the first request's last decode logits
             against a cache-less forward within 2e-2 of the floor between
             the two correct forwards, for moe at :func:`no_drop`'s
             capacity, then again at the default for tokens/s
      serve_kv_compression  (not ssm) the same requests with KV compression
             at ``kv_Delta_rel`` through a pallas engine, 4 a batch: after
             each batch's compression its correct call's pencils rechecked in
             float64, its loop's peak memory over its packed batch, and
             kernels 3p/4p's first call at each shape held bitwise against
             the twins, kernels 3p/4p counted

    A bf16 gate that CHECK_DEPTH moves is reported here, not held.  Returns
    the config, the bf16 params and a summary of the family's metrics."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.engine import CorrectionEngine
    from repro_torch.models.model import build_model

    cfg = cfg or get_config(arch, attention_impl="pallas")
    phase = dict(arch=cfg.name, family=cfg.family, layers=cfg.n_layers)
    lengths, requests = lm_requests(cfg, prompts)
    summary = {"arch": cfg.name, "layers": cfg.n_layers, **lm_float32(dev, cfg, phase, tokens, requests)}
    moved = ()
    if arch in CHECK_DEPTH:
        summary.update(lm_check_depth(dev, arch, cfg, phase, tokens, requests))
        moved = CHECK_DEPTH[arch][1]

    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = build_model(cfg, device=dev).init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = lm_batch(cfg, tokens, gen, dev)
    scored, counts = score(cfg, params, batch, dev)
    want_launches = family_layers(cfg)
    emit("lm_family", **phase, part="loss", tokens=list(tokens),
         stub_inputs={k: list(v.shape) for k, v in batch.items() if k != "tokens"}, init_seconds=init_s,
         params=sum(p.numel() for p in params.parameters()), **scored,
         other="ssm_chunk // 2" if cfg.family == "ssm" else "naive attention",
         launches={k: v for k, v in counts.items() if v}, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    require(scored["rel_diff"] <= 1e-3 or "loss" in moved, f"{arch}: loss {scored['loss']} and the second "
            f"forward's {scored['loss_other']} differ by {scored['rel_diff']:.2e} > 1e-3")
    require(counts["flash_attention"] == want_launches,
            f"{arch}: {counts['flash_attention']} flash_attention launches, want {want_launches}")
    if want_launches:
        flash = records["flash_attention"]
        flash["launches"] += counts["flash_attention"]
        flash.setdefault("launches_by_path", {})[f"loss {cfg.name}"] = counts["flash_attention"]
    forward = profile_lm(build_model(cfg, device=dev), params, batch, "lm_family", **phase)

    check_cfg = no_drop(cfg)
    served = serve_and_check(check_cfg, params, requests, dev)
    bar = 2e-2 + served["floor"]
    emit("lm_family", **phase, part="serve", requests=len(requests), prompt_lengths=lengths,
         capacity_factor=check_cfg.capacity_factor, new_tokens=served["tokens"], seconds=served["seconds"],
         tokens_per_s=served["tokens"] / served["seconds"], prefill_seconds=served["prefill_seconds"],
         decode_seconds=served["decode_seconds"], decode_vs_cacheless_max_abs=served["diff"],
         cacheless_floor_max_abs=served["floor"], bar=bar, logit_scale=served["scale"])
    require(all(0 <= t < cfg.vocab for r in served["done"] for t in r["tokens"]), f"{arch}: token out of vocab")
    require(served["diff"] <= bar or "decode" in moved, f"{arch}: bf16 decode logits differ from a cache-less "
            f"forward by {served['diff']} > {bar} (2e-2 + the floor)")
    summary.update(forward_seconds=scored["forward_seconds"], forward_idle_share=forward["idle_share"],
                   serve_tokens_per_s=served["tokens"] / served["seconds"])
    if cfg.family == "moe":
        plain = serve_and_check(cfg, params, requests, dev, check=False)
        summary["serve_tokens_per_s"] = plain["tokens"] / plain["seconds"]
        emit("lm_family", **phase, part="serve_default_capacity", capacity_factor=cfg.capacity_factor,
             new_tokens=plain["tokens"], seconds=plain["seconds"], tokens_per_s=summary["serve_tokens_per_s"],
             prefill_seconds=plain["prefill_seconds"], decode_seconds=plain["decode_seconds"])

    if cfg.family != "ssm":  # the reference serves mamba2 without KV compression too
        cfg_kv = dataclasses.replace(cfg, compression=dataclasses.replace(
            cfg.compression, kv_cache_compression=True, kv_Delta_rel=kv_Delta_rel))
        pallas = CorrectionEngine(backend="batched", fft_impl="pallas", device=dev)
        captured, undo = first_calls(*path_wrappers(even=True))
        calls, stop = record_correct(pallas, held=lambda: captured_bytes(captured))
        batches = []  # each batch's correct calls, sub-tensors and recheck

        def check_batch():
            # a batch's pencils rechecked and the kernels' first calls held,
            # then let go, before the next batch: two batches of llava's
            # cache (~0.9 G values each) with their errors, corrections and
            # captured kernel inputs would not fit beside the model
            batches.append((len(calls), sum(len(c[0]) for c in calls), recheck_calls(f"{arch} KV", calls)))
            calls.clear()
            without_counting(lambda: hold_at_path_shapes(f"lm_family {cfg.name}", records, captured))
            captured.clear()

        kv_batch = 4
        read = reset_launches()
        try:
            served_kv = serve_and_check(cfg_kv, params, requests, dev, check=False, engine=pallas,
                                        after_compress=check_batch, max_batch=kv_batch)
        finally:
            undo()
            stop()
        counts = read()
        n_calls = sum(b[0] for b in batches)
        rechecks = [b[2] for b in batches]
        values = sum(r["values"] for r in rechecks)
        differ = sum(a != b for r0, r1 in zip(served["done"], served_kv["done"])
                     for a, b in zip(r0["tokens"], r1["tokens"]))
        emit("lm_family", **phase, part="serve_kv_compression", kv_Delta_rel=kv_Delta_rel, max_batch=kv_batch,
             correct_calls=n_calls, sub_tensors=sum(b[1] for b in batches), values=values,
             pencils=sum(r["pencils"] for r in rechecks), new_tokens=served_kv["tokens"],
             seconds=served_kv["seconds"], tokens_per_s=served_kv["tokens"] / served_kv["seconds"],
             prefill_seconds=served_kv["prefill_seconds"], compress_seconds=served_kv["compress_seconds"],
             decode_seconds=served_kv["decode_seconds"],
             worst_abs_over_E=max(r["worst_abs_over_E"] for r in rechecks),
             worst_spectrum_over_Delta=max(r["worst_spectrum_over_Delta"] for r in rechecks),
             loop_memory_factor=max(r["loop_memory_factor"] for r in rechecks),
             recheck_and_hold_seconds=served_kv["after_compress_seconds"],
             tokens_differing_from_uncompressed=differ, launches={k: v for k, v in counts.items() if v})
        want_calls = -(-len(requests) // kv_batch)
        require(n_calls == want_calls and len(batches) == want_calls, f"{arch}: {n_calls} correct calls in "
                f"{len(batches)} compressions, want one a batch ({want_calls})")
        require(all(0 <= t < cfg.vocab for r in served_kv["done"] for t in r["tokens"]),
                f"{arch}: token out of vocab with KV compression")
        launches_on_path(records, counts, f"serve {cfg.name}")
        summary.update(compress_seconds=served_kv["compress_seconds"], kv_values=values)
    return cfg, params, summary


# phase checkpoint's tokens a step (whisper-tiny: its decoder's 448
# positions; the frames are its 1500 encoder positions)
CHECKPOINT_TOKENS = (4, 448)
# checkpoints of the train and checkpoint phases: under build/ (ignored by
# git), removed when each phase ends
WORK_DIR = ROOT / "build" / "chip_smoke_ckpt"


def phase_train(dev, cfg=None, tokens=(4, 2048), grad_Delta_rel=5e-5, steps=4, fail_at=3, ckpt_every=2):
    """The training path: ``Trainer`` on qwen2-0.5b (full width and depth
    when ``cfg`` is None; bf16 blocks, float32 head, ``remat="dots"``,
    ``attention_impl="xla_flash"``), ``tokens`` a batch, FFCz gradient
    compression at the reference's defaults but ``grad_Delta_rel``: the
    quantizer's errors are at most E * 2^-8, so at the default 1e-2 the
    correction never acts, and below 2^-8 it does (at 5e-5 every pencil of
    a random gradient takes 2 iterations).  An uninterrupted run of
    ``steps``; then a run with raw checkpoints every ``ckpt_every`` steps
    (async writes) and a failure injected at ``fail_at``, and a new Trainer
    on its directory that resumes at the last committed step and ends at
    ``steps`` with the uninterrupted run's loss (rtol 1e-4, the reference
    test's).  Step seconds are the uninterrupted run's; the seconds of
    ``compress_gradients`` and the loop's iteration histogram are recorded
    on the resumed run's steps.  Returns the resumed trainer."""
    import dataclasses
    import shutil
    import statistics

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.engine import CorrectionEngine
    from repro_torch.launch import steps as steps_mod
    from repro_torch.runtime import SimulatedFailure, Trainer, TrainerConfig

    cfg = cfg or get_config("qwen2-0.5b")
    cfg = dataclasses.replace(cfg, compression=dataclasses.replace(
        cfg.compression, grad_compression=True, grad_Delta_rel=grad_Delta_rel))
    shutil.rmtree(WORK_DIR, ignore_errors=True)

    def run_cfg(name, **kw):
        return TrainerConfig(seq_len=tokens[1], global_batch=tokens[0], ckpt_dir=str(WORK_DIR / name),
                             **{"ckpt_every": ckpt_every, "log_every": 1, **kw})

    compress_s, hist = [], {}
    compress = steps_mod.compress_gradients

    def timed(grads, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = compress(grads, **kw)
        torch.cuda.synchronize()
        compress_s.append(time.perf_counter() - t)
        return out

    # the engine compress_gradients picks (default_engine of the gradients'
    # device) is recorded through its class: "cuda" and "cuda:0" are two keys
    correct = CorrectionEngine.correct

    def recording(self, *args, **kw):
        out = correct(self, *args, **kw)
        iters = out[-1].block_iterations.cpu().numpy()
        for k, v in zip(*np.unique(iters, return_counts=True)):
            hist[int(k)] = hist.get(int(k), 0) + int(v)
        return out

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    a = Trainer(cfg, run_cfg("uninterrupted", ckpt_every=10**6), device=dev)  # saves at its end only
    init_s = time.perf_counter() - t0
    out_a = a.train(steps)
    peak = torch.cuda.max_memory_allocated()
    step_s = [m["dt"] for m in out_a["metrics"]]
    losses_a = [m["loss"] for m in out_a["metrics"]]
    del a
    torch.cuda.empty_cache()

    b = Trainer(cfg, run_cfg("resumed", inject_failure_at=fail_at), device=dev)
    failed = False
    try:
        b.train(steps)
    except SimulatedFailure:
        failed = True
    losses_b = [m["loss"] for m in b.metrics]
    del b
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    c = Trainer(cfg, run_cfg("resumed"), device=dev)
    restore_s = time.perf_counter() - t0
    start = c.start_step
    # compress seconds and the iteration histogram come from the resumed
    # run's steps: the timed steps above and the profiled step below run
    # without these wrappers
    steps_mod.compress_gradients, CorrectionEngine.correct = timed, recording
    try:
        out_c = c.train(steps - start)
    finally:
        steps_mod.compress_gradients, CorrectionEngine.correct = compress, correct

    # where a step's time goes: one more step of the resumed trainer
    batch = c.pipeline.batch_at(steps)

    def one_step():
        c.params, c.opt_state, loss = c._step(c.params, c.opt_state, batch)
        float(loss)

    profile = device_profile(one_step, top=10)
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    losses_c = [m["loss"] for m in out_c["metrics"]]
    gap = abs(out_c["final_loss"] - out_a["final_loss"]) / abs(out_a["final_loss"])
    median = statistics.median(step_s)
    emit("train", config=cfg.name, n_layers=cfg.n_layers, remat=cfg.remat, attention_impl=cfg.attention_impl,
         tokens=list(tokens), grad_Delta_rel=grad_Delta_rel,
         why_grad_Delta_rel=("the quantizer's errors are at most E*2^-bits, so every pencil's spectrum is at most "
                             "block*E*2^-bits: below Delta = Delta_rel*block*E unless Delta_rel < 2^-bits = 3.9e-3"),
         init_seconds=init_s, step_seconds=step_s, step_seconds_median=median,
         tokens_per_s=tokens[0] * tokens[1] / median, compress_gradients_seconds=compress_s,
         compress_gradients_seconds_median=statistics.median(compress_s), iterations_histogram=hist,
         loss_uninterrupted=losses_a, loss_before_failure=losses_b, injected_failure=failed,
         resumed_at=start, restore_seconds=restore_s, loss_resumed=losses_c, final_loss_rel_gap=gap,
         peak_memory_gb=peak / 1e9, profile_one_step=profile)
    require(all(np.isfinite(losses_a + losses_b + losses_c)), "train: a loss is not finite")
    require(failed, "train: the injected failure did not happen")
    require(start == (fail_at // ckpt_every) * ckpt_every, f"train: resumed at step {start}")
    require(out_c["final_step"] == steps, f"train: the resumed run ended at step {out_c['final_step']}")
    require(gap <= 1e-4, f"train: resumed final loss differs from the uninterrupted run's by {gap:.2e} > 1e-4")
    require(hist and sum(v for k, v in hist.items() if k >= 2) > sum(hist.values()) / 2,
            f"train: grad_Delta_rel={grad_Delta_rel} leaves most pencils untouched: {hist}")
    return c


# phase train_family: the moe, ssm, hybrid, vlm and audio families' Trainer at
# full width, depths cut (CUTS): arch -> (layers or None for the published
# depth, (rows, seq_len) a step; a vlm's seq_len counts its 2880 patches)
TRAIN_FAMILIES = {"granite-moe-3b-a800m": (8, (4, 2048)), "mamba2-2.7b": (16, (4, 2048)),
                  "zamba2-7b": (12, (4, 2048)), "llava-next-mistral-7b": (4, (2, 2880 + 2048)),
                  "whisper-tiny": (None, (4, 448))}
# the float32 gradient check's depth where not 2 layers: zamba2's first
# group (2 layers would hold no attention, only the mamba tail)
GRAD_CHECK_LAYERS = {"zamba2-7b": 6}
# the depth of the failure-and-resume runs (CUTS; None: the train depth):
# raw checkpoints move ~0.56 GB/s on the card's host, and a 1 G-parameter
# state is ~10 GB
RESUME_LAYERS = {"granite-moe-3b-a800m": 2, "mamba2-2.7b": 2, "zamba2-7b": 6, "llava-next-mistral-7b": 1,
                 "whisper-tiny": None}
# the leaf whose gradient the gradient check's planted fault zeroes: the
# family's own piece (the first parameter whose name starts so)
FAULT_LEAF = {"moe": "groups.0.moe_block.moe.router", "ssm": "layers.0.in_proj", "hybrid": "shared.attn.wqkv",
              "vlm": "projector.w1", "audio": "encoder.0.attn.wqkv"}


def loop_memory(engine_correct, held=lambda: 0):
    """Wrap an unbound ``CorrectionEngine.correct``: each call's packed
    (pencils, block) float32 bytes and its peak device memory above what was
    allocated when it began, less what ``held()`` grew by in the call (the
    harness's copies of the kernels' first-call inputs, :func:`first_calls`),
    over those bytes, are appended to the returned list; ``peak`` keeps the
    largest device peak seen across the calls (each call resets the peak
    statistics)."""
    import torch

    calls, peak = [], {"bytes": 0}

    def call(self, errs, Es, Ds, **kw):
        torch.cuda.synchronize()
        peak["bytes"] = max(peak["bytes"], torch.cuda.max_memory_allocated())
        base, kept = torch.cuda.memory_allocated(), held()
        torch.cuda.reset_peak_memory_stats()
        out = engine_correct(self, errs, Es, Ds, **kw)
        torch.cuda.synchronize()
        top = torch.cuda.max_memory_allocated()
        peak["bytes"] = max(peak["bytes"], top)
        packed = packed_bytes(errs, kw["block"])
        calls.append((packed, (top - base - (held() - kept)) / packed))
        return out

    call.peak = peak
    return call, calls


def largest_call_factor(calls):
    """The loop memory factor of the call with the largest packed batch (a
    call of a few pencils measures the allocator's rounding, not the loop)."""
    return max(calls)[1] if calls else 0.0


def packed_bytes(errs, block):
    """Bytes of the packed (pencils, block) float32 batch of ``errs``."""
    return 4 * block * sum(-(-e.numel() // block) for e in errs)


def captured_bytes(captured):
    """Device bytes of the tensors :func:`first_calls` keeps."""
    import torch

    return sum(v.numel() * v.element_size() for _ops, args, kw in captured.values()
               for v in (*args, *kw.values()) if isinstance(v, torch.Tensor))


def grad_check(dev, cfg, layers, tokens):
    """Float32 gradients of ``cfg`` at ``layers`` deep (whisper: as many
    encoder layers), full width, weights from seed 0, through the training
    path (``xla_flash``; moe at :func:`no_drop`'s capacity) against
    :func:`second_forward`'s (naive attention; mamba2: half the SSD chunk)
    on one pipeline batch of ``tokens`` (rows, text tokens; a vlm's patches
    before them): every leaf within 1e-4 of that
    leaf's largest |g|, and the same check missing that bar with
    FAULT_LEAF's gradient zeroed."""
    import dataclasses

    import torch

    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.models.model import build_model

    depth = {"n_layers": layers}
    if cfg.family == "audio":
        depth["encoder_layers"] = layers
    cfg32 = dataclasses.replace(no_drop(cfg), dtype="float32", attention_impl="xla_flash", **depth)
    params = build_model(cfg32, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    batch = pipeline_for(cfg32, vision_entries(cfg) + tokens[1], tokens[0], seed=1).batch_at(0)
    named = dict(params.named_parameters())

    def grads(c):
        with torch.enable_grad():
            loss = build_model(c, device=dev).loss(params, batch)
            return float(loss.detach()), torch.autograd.grad(loss, list(named.values()))

    t0 = time.perf_counter()
    loss, got = grads(cfg32)
    seconds = time.perf_counter() - t0
    loss_other, want = grads(second_forward(cfg32))

    def worst(gs):
        out = 0.0
        for g, w in zip(gs, want):
            scale = float(w.abs().max())
            diff = float((g - w).abs().max())
            out = max(out, diff / scale if scale > 0 else (0.0 if diff == 0 else float("inf")))
        return out

    fault = next(i for i, k in enumerate(named) if k.startswith(FAULT_LEAF[cfg.family]))
    clean = worst(got)
    faulty = worst([torch.zeros_like(g) if i == fault else g for i, g in enumerate(got)])
    result = {"check_layers": layers, "check_tokens": list(tokens), "leaves": len(named),
              "check_params": sum(p.numel() for p in params.parameters()), "loss": loss,
              "loss_other": loss_other, "other": "ssm_chunk // 2" if cfg.family == "ssm" else "naive attention",
              "worst_leaf_rel": clean, "planted_fault": f"zeroed {list(named)[fault]}",
              "faulty_worst_leaf_rel": faulty, "grad_seconds": seconds}
    del params, named, got, want
    torch.cuda.empty_cache()
    require(clean <= 1e-4, f"{cfg.name}: a float32 gradient leaf differs from the second path's by {clean:.2e} "
            "of its largest |g| > 1e-4")
    require(faulty > 1e-4, f"{cfg.name}: the gradients with {result['planted_fault']} are within the bar")
    return result


def phase_train_family(dev, records, arch, cfg=None, tokens=(4, 2048), check_tokens=(2, 512),
                       grad_Delta_rel=5e-5, steps=3, resume_layers=None):
    """``Trainer`` on one of the moe, ssm, hybrid, vlm and audio archs at
    full width (``cfg`` None: the published config at TRAIN_FAMILIES'
    depth; bf16 blocks, float32 head, ``remat="dots"``, ``attention_impl=
    "xla_flash"``), ``tokens`` a step, FFCz gradient compression at
    ``grad_Delta_rel`` through a pallas engine (kernels 3p/4p; 1p/2p for a
    leaf of odd length below the block), raw checkpoints:

      grad_check  :func:`grad_check` at 2 layers (GRAD_CHECK_LAYERS)
      train       ``steps`` steps: step seconds, tokens/s, peak device
                  memory, ``compress_gradients`` seconds, the iteration
                  histogram (more than half the pencils take 2 or more),
                  the loop's peak memory over its packed batch (the largest
                  call's: :func:`largest_call_factor`, on the steps before
                  the capture), the kernels' launches; the last step keeps
                  the first call of each kernel at each shape, held bitwise
                  against the twins after the run
      resume      at ``resume_layers`` deep (RESUME_LAYERS; None: ``cfg``'s
                  depth), every width kept: 2 uninterrupted steps; a run with
                  a checkpoint every step and a failure injected at step 1; a
                  new Trainer that resumes there and ends at step 2 within
                  rtol 1e-4 of the uninterrupted loss (save and restore
                  seconds, state bytes)

    A Trainer saves at the end of every ``train()``; the saves that nothing
    reads (the timed run's, the uninterrupted and the resumed runs') are
    skipped.  Returns the arch's summary."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core.engine import CorrectionEngine
    from repro_torch.launch import steps as steps_mod
    from repro_torch.runtime import SimulatedFailure, Trainer, TrainerConfig

    t_arch = time.perf_counter()
    if cfg is None:
        layers = TRAIN_FAMILIES[arch][0]
        cfg = get_config(arch, **({} if layers is None else {"n_layers": layers}))
    cfg = dataclasses.replace(cfg, remat="dots", attention_impl="xla_flash", compression=dataclasses.replace(
        cfg.compression, grad_compression=True, grad_Delta_rel=grad_Delta_rel))
    phase = dict(arch=cfg.name, family=cfg.family, layers=cfg.n_layers)
    check = grad_check(dev, cfg, min(GRAD_CHECK_LAYERS.get(arch, 2), cfg.n_layers), check_tokens)
    emit("train_family", **phase, part="grad_check", **check)

    work = WORK_DIR / "train_family"
    shutil.rmtree(work, ignore_errors=True)
    engine = CorrectionEngine(fft_impl="pallas", device=dev)

    def trainer(c, name, save=True, **kw):
        run = TrainerConfig(seq_len=tokens[1], global_batch=tokens[0], ckpt_dir=str(work / name),
                            **{"ckpt_every": 1, "log_every": 1, **kw})
        t = Trainer(c, run, device=dev, engine=engine)
        if not save:
            t.ckpt.save = lambda *args, **kw: None
        return t

    # train: the timed steps, every wrapper on; the capture on the last step only
    compress_s, hist = [], {}
    compress, correct = steps_mod.compress_gradients, CorrectionEngine.correct
    measured, calls = loop_memory(correct)

    def timed(grads, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = compress(grads, **kw)
        torch.cuda.synchronize()
        compress_s.append(time.perf_counter() - t)
        return out

    def recording(self, *args, **kw):
        out = measured(self, *args, **kw)
        iters = out[-1].block_iterations.cpu().numpy()
        for k, v in zip(*np.unique(iters, return_counts=True)):
            hist[int(k)] = hist.get(int(k), 0) + int(v)
        return out

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    t = trainer(cfg, "timed", save=False)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in t.params.parameters())
    steps_mod.compress_gradients, CorrectionEngine.correct = timed, recording
    read = reset_launches()
    try:
        t.train(steps - 1)
        peak = max(measured.peak["bytes"], torch.cuda.max_memory_allocated())
        uncaptured = list(calls)
        captured, undo = first_calls(*path_wrappers(even=True), *path_wrappers(even=False))
        try:
            t.train(1)
        finally:
            undo()
    finally:
        steps_mod.compress_gradients, CorrectionEngine.correct = compress, correct
    counts = read()
    step_s = [m["dt"] for m in t.metrics]
    losses_t = [m["loss"] for m in t.metrics]
    del t
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    without_counting(lambda: hold_at_path_shapes(f"train_family {cfg.name}", records, captured))
    del captured
    torch.cuda.empty_cache()
    hold_s = time.perf_counter() - t0
    median = float(np.median(step_s))
    launched = {k: v for k, v in counts.items() if v}
    factor = largest_call_factor(uncaptured)
    emit("train_family", **phase, part="train", params=n_params, remat=cfg.remat,
         attention_impl=cfg.attention_impl, tokens=list(tokens), grad_Delta_rel=grad_Delta_rel,
         init_seconds=init_s, step_seconds=step_s, step_seconds_median=median,
         tokens_per_s=tokens[0] * tokens[1] / median, compress_gradients_seconds=compress_s,
         iterations_histogram=hist, loop_memory_factor=factor,
         loop_calls_mb_and_factor=[[b / 1e6, f] for b, f in sorted(uncaptured, reverse=True)[:4]],
         losses=losses_t, peak_memory_gb=peak / 1e9, launches=launched, hold_seconds=hold_s)
    require(all(np.isfinite(losses_t)), f"train_family {arch}: a loss is not finite")
    require(hist and sum(v for k, v in hist.items() if k >= 2) > sum(hist.values()) / 2,
            f"train_family {arch}: grad_Delta_rel={grad_Delta_rel} leaves most pencils untouched: {hist}")
    for k in ("fcube_rows", "scube_rows"):
        if counts[k]:
            launches_on_path(records, counts, f"train {cfg.name}", (k,))
    launches_on_path(records, counts, f"train {cfg.name}")

    # resume: checkpoint every step, a failure at step 1, a resumed Trainer
    cut = cfg if resume_layers is None else dataclasses.replace(cfg, n_layers=resume_layers)
    a = trainer(cut, "uninterrupted", save=False)
    out_a = a.train(2)
    losses_a = [m["loss"] for m in out_a["metrics"]]
    state_bytes = sum(x.numel() * x.element_size() for x in tree.leaves(a.state()))
    del a
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    b = trainer(cut, "resumed", inject_failure_at=1)
    failed = False
    try:
        b.train(2)
    except SimulatedFailure:
        failed = True
    losses_b = [m["loss"] for m in b.metrics]
    del b
    torch.cuda.empty_cache()
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    c = trainer(cut, "resumed", save=False)
    restore_s = time.perf_counter() - t0
    start = c.start_step
    out_c = c.train(2 - start)
    losses_c = [m["loss"] for m in out_c["metrics"]]
    del c
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    gap = abs(out_c["final_loss"] - out_a["final_loss"]) / abs(out_a["final_loss"])
    emit("train_family", **phase, part="resume", resume_layers=cut.n_layers, state_bytes=state_bytes,
         loss_uninterrupted=losses_a, loss_before_failure=losses_b, injected_failure=failed, resumed_at=start,
         step_and_save_seconds=save_s, restore_seconds=restore_s, loss_resumed=losses_c,
         final_loss_rel_gap=gap, arch_seconds=time.perf_counter() - t_arch)
    require(all(np.isfinite(losses_a + losses_b + losses_c)), f"train_family {arch}: a loss is not finite")
    require(failed, f"train_family {arch}: the injected failure did not happen")
    require(start == 1, f"train_family {arch}: resumed at step {start}, want 1")
    require(out_c["final_step"] == 2, f"train_family {arch}: the resumed run ended at {out_c['final_step']}")
    require(gap <= 1e-4, f"train_family {arch}: resumed final loss differs from the uninterrupted run's by "
            f"{gap:.2e} > 1e-4")
    return {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params, "step_seconds_median": median,
            "tokens_per_s": tokens[0] * tokens[1] / median, "peak_memory_gb": peak / 1e9,
            "loop_memory_factor": factor, "grad_check_worst_leaf_rel": check["worst_leaf_rel"],
            "launches": launched, "resume_layers": cut.n_layers, "resume_gap": gap,
            "seconds": time.perf_counter() - t_arch}

def launches_on_path(records, counts, path, kernels=("rfft_fwd_epilogue_rows", "unpack_sclip_rows")):
    """Add a path's launches of ``kernels`` to their summary records."""
    for k in kernels:
        require(counts[k] > 0, f"{path}: kernel {k} never launched")
        records[k]["launches"] += counts[k]
        records[k].setdefault("launches_by_path", {})[path] = counts[k]


PENCIL_WRAPPERS = ("fwd_epilogue_fused", "unpack_sclip_fused")  # kernels 3, 4 (repro_torch.kernels.rfft.ops)


def path_wrappers(even=True):
    """The (ops module, wrapper names) groups of the POCS loop's kernels:
    kernels 3 and 4 when the last axis (or the pencil) is even, 2 and 1 when
    it is odd.  Each wrapper takes its whole-field and per-pencil modes."""
    from repro_torch.kernels.fcube import ops as fcube_ops
    from repro_torch.kernels.rfft import ops as rfft_ops
    from repro_torch.kernels.scube import ops as scube_ops

    if even:
        return ((rfft_ops, PENCIL_WRAPPERS),)
    return ((fcube_ops, ("project_fcube_fused",)), (scube_ops, ("project_scube_fused",)))


def first_calls(*groups):
    """Wrap ``ops.<name>`` for each ``(ops, names)`` of ``groups`` so that the
    first call at each shape of its first argument keeps clones of its
    tensor arguments, taken before the call.  Returns the captured calls,
    ``{(name, shape): (ops, args, kwargs)}``, and a function that puts the
    wrappers back."""
    import torch

    captured, orig = {}, {(ops, n): getattr(ops, n) for ops, names in groups for n in names}

    def clone(v):
        return v.clone() if isinstance(v, torch.Tensor) else v

    def wrap(ops, name, fn):
        def call(*args, **kw):
            key = (name, tuple(args[0].shape))
            if key not in captured:
                captured[key] = (ops, [clone(a) for a in args], {k: clone(v) for k, v in kw.items()})
            return fn(*args, **kw)

        return call

    for (ops, name), fn in orig.items():
        setattr(ops, name, wrap(ops, name, fn))

    def undo():
        for (ops, name), fn in orig.items():
            setattr(ops, name, fn)

    return captured, undo


def row_slices(args, kw, rows, a, b):
    """A per-pencil call's arguments cut to rows ``[a, b)``: every tensor of
    ``rows`` rows sliced, a shape tuple starting with ``rows`` shortened."""
    import torch

    def cut(v):
        if isinstance(v, torch.Tensor) and v.ndim and v.shape[0] == rows:
            return v[a:b]
        if isinstance(v, tuple) and v and v[0] == rows:
            return (b - a,) + v[1:]
        return v

    return [cut(v) for v in args], {k: cut(v) for k, v in kw.items()}


def per_pencil(args, kw):
    """True for a call in the kernels' per-pencil mode (its rows
    independent): ``per_row=True``, or a bound of one value a row."""
    from repro_torch.kernels.build import is_row_bound

    return bool(kw.get("per_row")) or any(is_row_bound(v, args[0].shape) for v in args[1:])


def plain_equals(ops, name, args, kw, got, chunk=1 << 26):
    """The plain twin of ``ops.<name>`` on ``args`` equals ``got`` bitwise;
    a per-pencil call is compared in blocks of rows (about ``chunk`` values
    of its first argument each), so the twin's temporaries stay small at a
    gradient's billion values."""
    import torch

    plain = getattr(ops, name.replace("_fused", "_plain"))
    rows = args[0].shape[0]
    if not per_pencil(args, kw) or args[0].numel() <= chunk:
        want = plain(*[v.clone() if isinstance(v, torch.Tensor) else v for v in args], **kw)
        return len(got) == len(want) and all(same(g, w) for g, w in zip(got, want))
    step = max(1, chunk * rows // args[0].numel())
    for a in range(0, rows, step):
        b = min(rows, a + step)
        sliced, sliced_kw = row_slices(args, kw, rows, a, b)
        want = plain(*sliced, **sliced_kw)
        if len(got) != len(want) or not all(same(g[a:b], w) for g, w in zip(got, want)):
            return False
    return True


def hold_at_path_shapes(path, records, captured):
    """Replay each call captured by :func:`first_calls` on the kernel and on
    its plain twin (:func:`plain_equals`): every output bitwise equal.  The
    replay's launches are not the path's: call this outside the path's
    count."""
    import torch

    def clone(v):
        return v.clone() if isinstance(v, torch.Tensor) else v

    checks = []
    for (name, shape), (ops, args, kw) in captured.items():
        read = reset_launches()
        got = getattr(ops, name)(*map(clone, args), **kw)
        launched = [k for k, v in read().items() if v]
        bitwise = plain_equals(ops, name, args, kw, got)
        del got
        kernel = launched[0] if len(launched) == 1 else None
        checks.append({"kernel": kernel, "shape": list(shape), "bitwise": bitwise})
        require(kernel is not None, f"{path}: {name} at {shape} launched {launched}, want one kernel")
        require(bitwise, f"{path}: {name} ({kernel}) != its twin at {shape}")
        if kernel is not None:
            records[kernel].setdefault("shapes_held_on_paths", {}).setdefault(path, []).append(list(shape))
    emit(path, part="kernels_at_path_shapes", checks=checks)
    require(bool(checks), f"{path}: no call of the loop's kernels was captured")


def phase_grad_pallas(dev, records, trainer):
    """``compress_gradients`` on one step's gradients of ``trainer``'s model
    (the reference's tree layout: each layer tensor stacked on a layer axis),
    with ``CorrectionEngine(fft_impl="pallas")`` (kernels 3, 4 per pencil)
    and ``"xla"``, at the trainer's compression settings.  Each run's
    corrected errors rechecked in float64 on the host as in phase pencils;
    seconds of the second call of each (the first builds cuFFT plans).  The
    pallas run's first call keeps the inputs of kernels 3 and 4 at each
    pencil length, replayed against the twins before the timed call."""
    import torch

    from repro_torch import tree
    from repro_torch.convert import lm_params_to_reference
    from repro_torch.core.engine import CorrectionEngine
    from repro_torch.kernels.rfft import ops as rfft_ops
    from repro_torch.optim import compress_gradients

    comp = trainer.cfg.compression
    named = dict(trainer.params.named_parameters())
    with torch.enable_grad():
        loss = trainer.bundle.loss(trainer.params, trainer.pipeline.batch_at(trainer.start_step))
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    grads = lm_params_to_reference(grads, trainer.cfg)
    n_values = sum(g.numel() for g in tree.leaves(grads))
    kw = dict(bits=comp.grad_bits, E_rel=comp.grad_E_rel, Delta_rel=comp.grad_Delta_rel, block=comp.grad_block)
    for impl in ("pallas", "xla"):
        engine = CorrectionEngine(fft_impl=impl, device=dev)
        if impl == "pallas":
            captured, undo = first_calls((rfft_ops, PENCIL_WRAPPERS))
        try:
            compress_gradients(grads, engine=engine, **kw)  # warm-up: cuFFT plans
        finally:
            if impl == "pallas":
                undo()
        if impl == "pallas":
            hold_at_path_shapes("grad_pallas", records, captured)
            del captured
        calls, stop = record_correct(engine)
        read = reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = compress_gradients(grads, engine=engine, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read()
        stop()
        rechecked = recheck_calls(f"grad_pallas {impl}", calls)
        del calls
        # what the store in the gradient's dtype adds on top (reported only)
        store = 0.0
        for g, o in zip(tree.leaves(grads), tree.leaves(out)):
            if g.numel() >= 2:
                E = comp.grad_E_rel * float(g.float().abs().max())
                store = max(store, float((o.float() - g.float()).abs().max()) / E)
        del out
        emit("grad_pallas", fft_impl=impl, values=n_values, leaves=len(tree.leaves(grads)),
             blocks=rechecked["blocks"], seconds=seconds, iterations_histogram=rechecked["iterations_histogram"],
             worst_abs_over_E=rechecked["worst_abs_over_E"],
             worst_spectrum_over_Delta=rechecked["worst_spectrum_over_Delta"], stored_dtype_worst_abs_over_E=store,
             launches={k: v for k, v in counts.items() if v})
        if impl == "pallas":
            launches_on_path(records, counts, "grad_pallas")


def parse_b_header(data):
    """E, Delta, block and shape from a tag-``B`` checkpoint leaf."""
    import struct

    _dt, E, Delta, block, ndim = struct.unpack_from("<BddIB", data, 1)
    shape = struct.unpack_from(f"<{ndim}Q", data, 1 + struct.calcsize("<BddIB"))
    return E, Delta, block, shape


def phase_checkpoint(dev, records, cfg=None, tokens=(4, 2048), n_layers=2):
    """A ``CheckpointManager`` with ``CheckpointCodec(enabled=True,
    engine=CorrectionEngine(fft_impl="pallas"))`` (the reference's codec
    defaults) saves a trained (params, opt_state) of ``cfg`` (default
    qwen2-0.5b) at full width (two steps from a Trainer), cut to
    ``n_layers`` deep (``None``: its own depth); a new Trainer on its
    directory restores it, and takes one more step.  Every ``B`` leaf within
    its stored E, every full pencil's spectrum within its stored Delta *
    (1 + 1e-5) + tau (float64, host); ``R`` leaves bitwise.  Stage seconds
    are summed over the codec's host threads (they overlap).  The save keeps
    the inputs of the first call of kernels 3 and 4 at each pencil length
    (a device copy, inside the timed save), replayed against the twins
    after it."""
    import dataclasses
    import os
    import resource
    import shutil
    import threading

    import numpy as np
    import torch

    from repro_torch import tree
    from repro_torch.checkpoint import CheckpointCodec, CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.engine import CorrectionEngine
    from repro_torch.kernels.rfft import ops as rfft_ops
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = cfg or get_config("qwen2-0.5b")
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers)
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    run = dict(seq_len=tokens[1], global_batch=tokens[0], ckpt_every=10**6, ckpt_async=False, log_every=1)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, TrainerConfig(ckpt_dir=str(WORK_DIR / "raw"), **run), device=dev)
    trainer.train(2)
    train_s = time.perf_counter() - t0
    state = trainer.state()
    saved = [t.detach().cpu() for t in tree.leaves(state)]
    del trainer

    codec = CheckpointCodec(enabled=True, engine=CorrectionEngine(fft_impl="pallas", device=dev))
    stage_s, lock = {}, threading.Lock()

    def timed(name, obj, attr):
        fn = getattr(obj, attr)

        def call(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            with lock:
                stage_s[name] = stage_s.get(name, 0.0) + time.perf_counter() - t
            return out

        setattr(obj, attr, call)

    for name, obj, attr in (("plan", codec.engine, "plan_pencils"), ("base", codec.base, "compress"),
                            ("correct", codec.engine, "correct"), ("encode", codec.engine, "encode_pencils")):
        timed(name, obj, attr)
    directory = WORK_DIR / "compressed"
    mgr = CheckpointManager(str(directory), codec=codec, keep=1)
    captured, undo = first_calls((rfft_ops, PENCIL_WRAPPERS))
    read = reset_launches()
    t0 = time.perf_counter()
    try:
        mgr.save(2, state)
    finally:
        undo()
    save_s = time.perf_counter() - t0
    counts = read()
    del state
    hold_at_path_shapes("checkpoint", records, captured)
    del captured
    step_dir = directory / "step_000000000002"
    blobs = [(step_dir / f"{i}.bin").read_bytes() for i in range(len(saved))]

    # the restoring Trainer decodes the B leaves whatever its own codec
    # settings; with compression off, its save after the extra step is raw
    t0 = time.perf_counter()
    restored_trainer = Trainer(cfg, TrainerConfig(ckpt_dir=str(directory), **run), device=dev)
    restore_s = time.perf_counter() - t0
    require(restored_trainer.start_step == 2, f"checkpoint: restored at step {restored_trainer.start_step}")
    restored = [t.detach().cpu() for t in tree.leaves(restored_trainer.state())]

    t0 = time.perf_counter()
    tags, worst_s, worst_f = {}, 0.0, 0.0
    for a, b, data in zip(saved, restored, blobs):
        tag = data[:1].decode()
        n, m = tags.get(tag, (0, 0))
        tags[tag] = (n + 1, m + a.numel())
        require(a.shape == b.shape and a.dtype == b.dtype, "checkpoint: a leaf changed shape or dtype")
        if tag == "R":
            require(torch.equal(a, b), "checkpoint: a raw leaf is not bitwise")
            continue
        require(tag == "B", f"checkpoint: unexpected tag {tag}")
        E, Delta, block, _shape = parse_b_header(data)
        diff = (b.double() - a.double()).numpy().reshape(-1)
        worst_s = max(worst_s, float(np.abs(diff).max()) / E)
        require(float(np.abs(diff).max()) <= E, f"checkpoint: a restored value exceeds E={E}")
        mag, tau = pencil_spectra(diff, block)
        if mag.size:
            worst_f = max(worst_f, float((mag / Delta).max()))
        require(bool(np.all(mag <= Delta * (1 + 1e-5) + tau)),
                f"checkpoint: a pencil's spectrum exceeds Delta={Delta}")
    check_s = time.perf_counter() - t0
    raw_bytes = sum(t.numel() * t.element_size() for t in saved)
    stored = sum(os.path.getsize(step_dir / f"{i}.bin") for i in range(len(saved)))
    del saved, restored
    loss = restored_trainer.train(1)["final_loss"]
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    emit("checkpoint", config=cfg.name, n_layers=cfg.n_layers, vocab=cfg.vocab, fft_impl="pallas",
         leaves_by_tag={k: {"leaves": n, "values": m} for k, (n, m) in tags.items()},
         raw_bytes=raw_bytes, stored_bytes=stored, ratio=raw_bytes / stored, save_seconds=save_s,
         stage_thread_seconds=stage_s, restore_seconds=restore_s, check_seconds=check_s,
         train_seconds=train_s, host_peak_rss_gb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
         worst_abs_over_E=worst_s,
         worst_spectrum_over_Delta=worst_f, loss_after_restore=loss,
         launches={k: v for k, v in counts.items() if v})
    require(np.isfinite(loss), "checkpoint: the restored trainer's loss is not finite")
    require(tags.get("B", (0, 0))[0] > 0, "checkpoint: no leaf was compressed")
    launches_on_path(records, counts, "checkpoint")


# -- the service path (slice 7): temporal streams, the FFCz service, sessions --

SERVICE_DIR = ROOT / "build" / "chip_smoke_wal"  # session journals (ignored by git), removed after


def sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


class StageClock:
    """Wall seconds of named calls: ``targets`` is ``[(stage, obj, attr)]``;
    while the clock is on, each ``obj.attr`` adds its calls' seconds to its
    stage (``take()`` returns and clears the sums)."""

    def __init__(self, targets):
        self.targets, self.sums, self.saved = targets, {}, []

    def __enter__(self):
        for stage, obj, attr in self.targets:
            fn = getattr(obj, attr)
            self.saved.append((obj, attr, fn, attr in vars(obj)))

            def call(*args, _fn=fn, _stage=stage, **kw):
                t = time.perf_counter()
                try:
                    return _fn(*args, **kw)
                finally:
                    self.sums[_stage] = self.sums.get(_stage, 0.0) + time.perf_counter() - t

            setattr(obj, attr, call)
        return self

    def __exit__(self, *exc):
        for obj, attr, fn, own in reversed(self.saved):
            if own:
                setattr(obj, attr, fn)
            else:
                delattr(obj, attr)

    def take(self):
        out, self.sums = self.sums, {}
        return out


def stream_stages(codec):
    """The stages of one stream frame, as :class:`StageClock` targets."""
    from repro_torch.core import temporal

    eng = codec.engine
    common = [("base", codec.base, "compress"), ("base", codec.base, "decompress")]
    if codec.stream.mode == "pencils":
        return common + [("plan", eng, "plan_pencils"), ("loop", eng, "correct"),
                         ("polish_encode", eng, "encode_pencils"), ("decode", temporal, "decode_pencil_blob")]
    return common + [("plan", eng, "plan_field"), ("loop", eng, "execute_field_async"),
                     ("polish", eng, "_finalize_field"), ("encode", eng, "encode_field"),
                     ("decode", codec._ffcz, "decompress")]


def encode_stream(dev, codec, frames, wrappers):
    """Encode ``frames`` with the launch counts zeroed just before and read
    just after, each frame's stage seconds on the clock, and the first call
    of the loop's kernels at each shape kept (``wrappers``: ops groups)."""
    captured, undo = first_calls(*wrappers)
    read = reset_launches()
    per_frame = []
    try:
        with StageClock(stream_stages(codec)) as clock:
            enc = codec.open_stream()
            for x in frames:
                t0 = time.perf_counter()
                enc.add_frame(x)
                sync(dev)
                per_frame.append({"seconds": time.perf_counter() - t0, **clock.take()})
            data = enc.finish()
    finally:
        undo()
    return enc, data, per_frame, read(), captured


def claimed_margins(x, dec, E, Delta, block=0):
    """Float64 margins of a decoded frame or pencil envelope against the
    scalar (E, Delta) it CLAIMS: whole-field rfftn, or (``block`` > 0) each
    full ``block``-pencil's rfft (:func:`pencil_spectra`; a padded last pencil
    is corrected with its pad, so only E holds there from the output:
    ROADMAP.md Queue 3).  Exact, with no tau: a stream header's and a pencil
    envelope's bounds are the claims from which the plan already took the
    float32 slack (``_residual_bounds``, ``plan_pencils``' ``E_proj`` and
    ``Delta_proj``), whereas :func:`recheck_pencils` holds the loop's own
    target bound, which a float32 FFT meets only to its rounding."""
    import numpy as np

    eps = dec.astype(np.float64) - np.asarray(x, np.float32).astype(np.float64)
    if block:
        mag = pencil_spectra(eps.reshape(-1), block)[0]
    else:
        spec = np.fft.rfftn(eps)
        mag = np.maximum(np.abs(spec.real), np.abs(spec.imag))
    return float(E - np.abs(eps).max()), float(Delta - mag.max(initial=0.0))


def check_stream(path, codec, data, frames):
    """Decode every frame: each within the header's (E, Delta) in float64,
    each seek (``decode_frame``) bitwise the sequential decode."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from repro_torch import host
    from repro_torch.core.temporal import TemporalStream

    s = TemporalStream.from_bytes(data)
    t0 = time.perf_counter()
    dec = codec.decompress_stream(data)
    decode_s = time.perf_counter() - t0
    # the frames' rechecks and seeks are independent: the host's threads
    # share them (numpy's FFTs release the interpreter lock)
    with ThreadPoolExecutor(host.THREADS) as pool:
        margins = list(pool.map(lambda xd: claimed_margins(*xd, s.E, s.Delta, s.block if s.mode == "pencils" else 0),
                                zip(frames, dec)))
        t0 = time.perf_counter()
        seeks = list(pool.map(lambda t: bool(np.array_equal(codec.decode_frame(data, t), dec[t])),
                              range(s.n_frames)))
        seek_s = time.perf_counter() - t0
    require(s.n_frames == len(frames), f"{path}: {s.n_frames} frames in the container")
    require(all(m[0] >= 0 and m[1] >= 0 for m in margins), f"{path}: a frame exceeds the header's bounds")
    require(all(seeks), f"{path}: a seek differs from the sequential decode")
    return {"bytes": len(data), "E": s.E, "Delta": s.Delta, "decode_seconds": decode_s, "seek_seconds": seek_s,
            "worst_spatial_margin": min(m[0] for m in margins), "worst_frequency_margin": min(m[1] for m in margins)}


EVEN_FIELD_KERNELS, ODD_FIELD_KERNELS = ("rfft_fwd_epilogue", "unpack_sclip"), ("fcube", "scube")
EVEN_PENCIL_KERNELS, ODD_PENCIL_KERNELS = ("rfft_fwd_epilogue_rows", "unpack_sclip_rows"), ("fcube_rows", "scube_rows")


def evolving_fields(shape, n, name="nyx-like-128", step=0.01):
    """A slowly evolving lognormal field: frame 0 is ``name``'s field (seed
    0), each next frame adds ``step`` of a fresh field of the same spectrum
    (seed t)."""
    import numpy as np

    from repro_torch.configs.ffcz_fields import FieldConfig
    from repro_torch.data.fields import make_field

    frames = [make_field(FieldConfig(name, shape, "lognormal", alpha=2.0, seed=0))]
    for t in range(1, n):
        fresh = make_field(FieldConfig(name, shape, "lognormal", alpha=2.0, seed=t))
        frames.append((frames[-1].astype(np.float64) + step * fresh).astype(np.float32))
    return frames


def pallas_engine_config(dev, **kw):
    """The service path's engine and bounds: ``fft_impl="pallas"``, E_rel =
    Delta_rel = 1e-3 unless ``kw`` says otherwise."""
    from repro_torch.core.engine import CorrectionEngine
    from repro_torch.core.ffcz import FFCzConfig

    cfg = FFCzConfig(**{"fft_impl": "pallas", "E_rel": 1e-3, "Delta_rel": 1e-3, **kw})
    return CorrectionEngine(fft_impl="pallas", device=dev), cfg


def phase_stream_field(dev, records, shape=(128, 128, 128), n_frames=5, n_odd=3, interval=4):
    """``TemporalCodec`` in field mode through the pallas engine: ``n_frames``
    of a slowly evolving lognormal field (``linear``, a keyframe every
    ``interval``) with ``warm_start`` on, then off (kernels 3, 4); then
    ``n_odd`` frames cropped to an odd last axis (kernels 1, 2).  Per-frame
    iterations (warm against cold) and stage seconds; every frame decoded
    and rechecked against the header's bounds in float64, every seek bitwise
    the sequential decode; the loop's kernels held bitwise against their
    twins at the first call of each shape."""
    import dataclasses

    import numpy as np

    from repro_torch.compressors import get_compressor
    from repro_torch.core.temporal import TemporalCodec, TemporalConfig

    t_phase = time.perf_counter()
    frames = evolving_fields(shape, n_frames)
    engine, cfg = pallas_engine_config(dev)
    stream = TemporalConfig(mode="field", predictor="linear", keyframe_interval=interval)
    totals, runs = {}, {}
    for label, warm, fr, even in (("warm", True, frames, True), ("cold", False, frames, True),
                                  ("odd_warm", True, [np.ascontiguousarray(f[..., :-1]) for f in frames[:n_odd]], False)):
        codec = TemporalCodec(get_compressor("szlike"), dataclasses.replace(cfg, warm_start=warm), stream,
                              engine=engine)
        enc, data, per_frame, counts, captured = encode_stream(dev, codec, fr, path_wrappers(even))
        hold_at_path_shapes("stream_field", records, captured)
        del captured
        check = check_stream("stream_field", codec, data, fr)
        iters = [st["iterations"] for st in enc.frame_stats]
        require(all(st["converged"] for st in enc.frame_stats), f"stream_field {label}: a frame did not converge")
        runs[label] = iters
        emit("stream_field", run=label, shape=list(fr[0].shape), frames=len(fr), warm_start=warm,
             keyframe_interval=interval, iterations=iters, frame_seconds=per_frame, **check,
             launches={k: v for k, v in counts.items() if v})
        for k in EVEN_FIELD_KERNELS if even else ODD_FIELD_KERNELS:
            totals[k] = totals.get(k, 0) + counts[k]
    warm_res = [i for t, i in enumerate(runs["warm"]) if t % interval]
    cold_res = [i for t, i in enumerate(runs["cold"]) if t % interval]
    emit("stream_field", part="warm_vs_cold", residual_iterations_warm=warm_res, residual_iterations_cold=cold_res,
         seconds=time.perf_counter() - t_phase)
    launches_on_path(records, totals, "stream_field", EVEN_FIELD_KERNELS + ODD_FIELD_KERNELS)


def phase_stream_eeg(dev, records, channels=128, samples=8192, n_frames=8, n_odd=3, odd_block=4095, interval=8,
                     Delta_rel=1e-4):
    """``TemporalCodec`` in pencil mode through the pallas engine on an EEG
    recording built as ``examples/stream_eeg_torch.py`` builds it:
    ``n_frames`` of (``channels``, ``samples``) with ``block=0`` (one pencil
    a channel, even: kernels 3p, 4p), ``linear``, a keyframe every
    ``interval``, ``warm_start`` on; then ``n_odd`` frames with
    ``odd_block`` (1p, 2p).  The same rechecks and seeks as
    :func:`phase_stream_field`.  ``Delta_rel`` is 1e-4: at 1e-3 the
    correction never acts on these frames (a pink pencil's spectrum peaks
    far above its base error's, so every pencil converges at its first
    check and kernels 4p and 1p never launch), as for the KV pencils
    (ROADMAP.md Queue 3)."""
    from repro_torch.compressors import get_compressor
    from repro_torch.core.temporal import TemporalCodec, TemporalConfig

    if str(ROOT) not in sys.path:  # the example's recording, from the checkout
        sys.path.insert(0, str(ROOT))
    from examples.stream_eeg_torch import make_eeg_frames

    t_phase = time.perf_counter()
    frames = make_eeg_frames(n_frames, channels, samples)
    engine, cfg = pallas_engine_config(dev, warm_start=True, Delta_rel=Delta_rel)
    totals = {}
    for label, fr, block, even in (("block0", frames, 0, True), ("odd_block", frames[:n_odd], odd_block, False)):
        stream = TemporalConfig(mode="pencils", predictor="linear", keyframe_interval=interval, block=block)
        codec = TemporalCodec(get_compressor("szlike"), cfg, stream, engine=engine)
        enc, data, per_frame, counts, captured = encode_stream(dev, codec, fr, path_wrappers(even))
        hold_at_path_shapes("stream_eeg", records, captured)
        del captured
        check = check_stream("stream_eeg", codec, data, fr)
        require(all(st["converged"] for st in enc.frame_stats), f"stream_eeg {label}: a frame did not converge")
        emit("stream_eeg", run=label, shape=[channels, samples], block=block or samples, frames=len(fr),
             Delta_rel=Delta_rel,
             iterations=[st["iterations"] for st in enc.frame_stats], frame_seconds=per_frame, **check,
             launches={k: v for k, v in counts.items() if v})
        for k in EVEN_PENCIL_KERNELS if even else ODD_PENCIL_KERNELS:
            totals[k] = totals.get(k, 0) + counts[k]
    emit("stream_eeg", part="done", seconds=time.perf_counter() - t_phase)
    launches_on_path(records, totals, "stream_eeg", EVEN_PENCIL_KERNELS + ODD_PENCIL_KERNELS)


def service_data(sizes=None):
    """The service phases' inputs, from seed 0: whole fields (1024^2 and
    128^3 lognormal), pencil tensors of 64 Ki - 1 Mi values, a 4-frame
    stream of 512^2 and a live session's 4 frames of 1024^2."""
    import numpy as np

    from repro_torch.configs.ffcz_fields import FieldConfig
    from repro_torch.data.fields import make_field

    sz = dict(plane=1024, cube=128, n_plane=8, n_cube=2, n_pencils=16, pencil_lo=1 << 16, pencil_hi=1 << 20,
              stream=512, frames=4)
    sz.update(sizes or {})
    rng = np.random.default_rng(0)
    fields = [make_field(FieldConfig(f"plane-{i}", (sz["plane"],) * 2, "lognormal", alpha=2.0, seed=i))
              for i in range(sz["n_plane"])]
    fields += [make_field(FieldConfig(f"cube-{i}", (sz["cube"],) * 3, "lognormal", alpha=2.0, seed=100 + i))
               for i in range(sz["n_cube"])]
    # white, as gradients and KV tensors are near enough: at E_rel = Delta_rel
    # = 1e-3 the correction acts on every bucket (a pink tensor's would not)
    pencils = [rng.standard_normal(int(rng.integers(sz["pencil_lo"], sz["pencil_hi"] + 1))).astype(np.float32)
               for _ in range(sz["n_pencils"])]
    stream = evolving_fields((sz["stream"],) * 2, sz["frames"], name="stream")
    session = evolving_fields((sz["plane"],) * 2, sz["frames"], name="session")
    return {"fields": fields, "pencils": pencils, "stream": stream, "session": session}


def run_service(dev, data, journal_dir, depth=2, injector=None, block=4096, max_batch=8, deadline_s=900.0):
    """Drive ``FFCzService`` once over ``data``: the compressions, a live
    session (appends, a duplicate retry, a finalize), then every produced
    blob submitted for decode, a quarter of them with a bit flipped in their
    middle.  Every request is admitted at once, so its latency holds the
    whole queue ahead of it: ``deadline_s`` covers that (the service's
    default of 30 s is a per-request budget for a stream of arrivals).
    Returns (service, requests {uid: (kind, input)}, responses, corrupted
    decode uids, seconds)."""
    import dataclasses

    import numpy as np

    from repro_torch.compressors import get_compressor
    from repro_torch.core.temporal import TemporalConfig
    from repro_torch.serving import FFCzService, ServiceConfig

    engine, cfg = pallas_engine_config(dev, crc=True)
    svc = FFCzService(get_compressor("szlike"), engine=engine, injector=injector,
                      config=ServiceConfig(max_batch=max_batch, block=block, pipeline_depth=depth,
                                           deadline_s=deadline_s, session_journal_dir=str(journal_dir)))
    reqs = {}
    for x in data["fields"]:
        reqs[svc.submit_compress(x, cfg)] = ("field", x)
    for x in data["pencils"]:
        reqs[svc.submit_pencils(x, 1e-3, 1e-3)] = ("pencils", x)
    stream = TemporalConfig(mode="field", predictor="linear", keyframe_interval=2)
    reqs[svc.submit_stream(data["stream"], dataclasses.replace(cfg, warm_start=True), stream)] = ("stream", data["stream"])
    sid = svc.open_session(cfg, stream)
    for t, x in enumerate(data["session"]):
        reqs[svc.submit_append(sid, t, x)] = ("append", t)
    reqs[svc.submit_append(sid, len(data["session"]) - 1, data["session"][-1])] = ("duplicate", len(data["session"]) - 1)
    reqs[svc.submit_finalize(sid)] = ("finalize", data["session"])
    t0 = time.perf_counter()
    responses = dict(svc.drain())
    compress_s = time.perf_counter() - t0
    corrupted = set()
    rng = np.random.default_rng(0)
    blobs = [(uid, r.payload) for uid, r in responses.items() if r.ok and isinstance(r.payload, bytes)]
    for i, (uid, blob) in enumerate(blobs):
        if i % 4 == 3:  # a bit flipped in the middle third (every format there is CRC'd)
            bad = bytearray(blob)
            bad[len(bad) // 3 + int(rng.integers(0, len(bad) // 3))] ^= 1 << int(rng.integers(0, 8))
            blob = bytes(bad)
        d = svc.submit_decompress(blob, uid=f"dec-{uid}")
        reqs[d] = ("decode", uid)
        if i % 4 == 3:
            corrupted.add(d)
    t0 = time.perf_counter()
    responses.update(svc.drain())
    decode_s = time.perf_counter() - t0
    svc.close()
    return svc, reqs, responses, corrupted, {"compress_seconds": compress_s, "decode_seconds": decode_s}


def decode_locally(svc, data):
    """What the service's decode of ``data`` returns, without the service."""
    import numpy as np

    from repro_torch.core.ffcz import FFCz, FFCzBlob, FFCzConfig
    from repro_torch.core.temporal import TemporalCodec, decode_pencil_blob

    if data[:4] == b"FFCS":
        return np.stack(TemporalCodec(svc.base, FFCzConfig(), engine=svc.engine).decompress_stream(data))
    if data[:4] == b"FFSB":
        return decode_pencil_blob(data, svc.base)
    return FFCz(svc.base, FFCzConfig(), engine=svc.engine).decompress(FFCzBlob.from_bytes(data))


def check_service(path, svc, reqs, responses, corrupted, faults=False):
    """Every request drained to exactly one disposition; the corrupted
    decodes alone rejected (and, without faults, nothing else); every
    completed compression within its bounds, rechecked in float64 on the
    decode the service returned (fields: the bounds the blob stores,
    :func:`recheck`; pencils: the envelope's; streams and the session's
    container: the header's, a frame at a time, :func:`claimed_margins`).
    Returns the worst margins."""
    import struct

    import numpy as np

    from repro_torch.core.ffcz import FFCzBlob
    from repro_torch.core.temporal import TemporalStream

    require(set(responses) == set(reqs), f"{path}: {len(set(reqs) - set(responses))} requests never drained")
    require(svc.counters["completed"] + svc.counters["rejected"] == len(reqs),
            f"{path}: completed + rejected != requests: {svc.counters}")
    decoded = {reqs[u][1]: r.payload for u, r in responses.items() if reqs[u][0] == "decode" and r.ok}
    worst = [np.inf, np.inf]
    for uid, r in responses.items():
        kind, what = reqs[uid]
        if kind == "decode":
            require(r.ok != (uid in corrupted), f"{path}: decode {uid} ok={r.ok}, corrupted={uid in corrupted}")
            if not r.ok:
                require(r.error["type"] == "BlobCorruptError", f"{path}: {uid} rejected as {r.error['type']}")
            continue
        if not faults:
            require(r.ok, f"{path}: {kind} request {uid} rejected: {r.error}")
        if not r.ok:
            continue
        if kind in ("append", "duplicate"):
            require(r.payload.seq == what and r.payload.duplicate == (kind == "duplicate"),
                    f"{path}: receipt {r.payload}")
            continue
        data = r.payload
        # a blob whose decode request was corrupted decodes here instead
        dec = decoded[uid] if uid in decoded else decode_locally(svc, data)
        if kind == "field":
            m = [recheck(what, dec, FFCzBlob.from_bytes(data))]
        elif kind == "pencils":
            E, Delta, block, _ = struct.unpack_from("<ddIB", data, 5)
            m = [claimed_margins(what, dec, E, Delta, block)]
        else:
            s = TemporalStream.from_bytes(data)
            m = [claimed_margins(x, d, s.E, s.Delta) for x, d in zip(what, dec)]
        worst = [min(worst[0], *(a for a, _ in m)), min(worst[1], *(b for _, b in m))]
        require(all(a >= 0 and b >= 0 for a, b in m), f"{path}: {kind} {uid} exceeds its bounds")
    return worst


def latency_summary(svc, reqs, responses):
    """Latency percentiles, counters, timers and the rungs taken.  A
    ``fallback:packed`` right after ``relax`` is counted apart
    (``relax_fallbacks``): the kernels take relax == 1.0 only, so a pallas
    request that did not converge re-runs on the packed transform, without
    kernels 1-4 (the reference's ladder; ROADMAP.md Queue 3).  The other
    fallbacks (``fault_fallbacks``) follow transient faults."""
    import numpy as np

    lat = np.asarray([r.stats.latency_s for r in responses.values()])
    rungs = {}
    relax_fallbacks = 0
    for r in responses.values():
        for i, g in enumerate(r.stats.rungs):
            rungs[g] = rungs.get(g, 0) + 1
            relax_fallbacks += g.startswith("fallback:") and i > 0 and r.stats.rungs[i - 1] == "relax"
    fallbacks = sum(n for g, n in rungs.items() if g.startswith("fallback:"))
    return {"requests": len(responses), "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3, "counters": dict(svc.counters),
            "timers": dict(svc.timers), "session_counters": dict(svc.sessions.counters), "rungs": rungs,
            "relax_fallbacks": relax_fallbacks, "fault_fallbacks": fallbacks - relax_fallbacks,
            "rejected_by_type": {t: sum(1 for r in responses.values() if not r.ok and r.error["type"] == t)
                                 for t in {r.error["type"] for r in responses.values() if not r.ok}}}


def response_bytes(responses):
    """Each response's payload as bytes (arrays by value, receipts by repr)
    beside its stats minus latency: what must not depend on the depth."""
    import dataclasses

    import numpy as np

    out = {}
    for uid, r in responses.items():
        p = r.payload
        p = p if isinstance(p, bytes) else p.tobytes() if isinstance(p, np.ndarray) else repr(p).encode()
        out[uid] = (r.ok, p, dataclasses.replace(r.stats, latency_s=0.0), r.error and r.error["type"])
    return out


def phase_service(dev, records, data, **kw):
    """``FFCzService`` over the pallas engine (``max_batch=8``, ``block=4096``,
    ``pipeline_depth=2``, file-backed session journals) on
    :func:`service_data`: every request drains, the corrupted decodes alone
    reject, every compression within its bounds in float64; no rung on any
    request and ``fft_impl == "pallas"`` on every field response (a
    fault-free run must not step down the ladder); then ``pipeline_depth=1``
    on the same data: byte-identical responses.  The depth-2 run keeps the
    first call of kernels 3, 4 (whole field and per pencil) at each shape,
    held bitwise against the twins after it."""
    import shutil

    shutil.rmtree(SERVICE_DIR, ignore_errors=True)
    t_phase = time.perf_counter()
    captured, undo = first_calls(*path_wrappers(even=True))
    read = reset_launches()
    try:
        svc, reqs, res, corrupted, secs = run_service(dev, data, SERVICE_DIR / "depth2", depth=2, **kw)
    finally:
        undo()
    counts = read()
    hold_at_path_shapes("service", records, captured)
    del captured
    worst = check_service("service", svc, reqs, res, corrupted)
    summary = latency_summary(svc, reqs, res)
    fields = [u for u in res if reqs[u][0] == "field"]
    require(not summary["rungs"], f"service: a fault-free run took rungs {summary['rungs']}")
    require(all(res[u].stats.fft_impl == "pallas" for u in fields), "service: a field response left the pallas rung")
    emit("service", depth=2, **secs, **summary, worst_spatial_margin=worst[0], worst_frequency_margin=worst[1],
         launches={k: v for k, v in counts.items() if v})
    launches_on_path(records, counts, "service", EVEN_FIELD_KERNELS + EVEN_PENCIL_KERNELS)
    t0 = time.perf_counter()
    svc1, reqs1, res1, _, secs1 = run_service(dev, data, SERVICE_DIR / "depth1", depth=1, **kw)
    same_bytes = response_bytes(res) == response_bytes(res1)
    emit("service", depth=1, **secs1, **latency_summary(svc1, reqs1, res1), byte_identical_to_depth2=same_bytes,
         seconds=time.perf_counter() - t0)
    require(list(res1) == list(res) and same_bytes, "service: depth 1 and depth 2 responses differ")
    emit("service", part="done", seconds=time.perf_counter() - t_phase)
    shutil.rmtree(SERVICE_DIR, ignore_errors=True)


def phase_service_faults(dev, records, data, **kw):
    """The same workload under ``FaultInjector(FaultConfig(p_codec=0.3,
    p_dispatch=0.3, p_oom=0.5, max_per_site=2), seed=7)``: every request
    drains, the ladder's ``fallback:packed`` and ``fallback:xla`` and a pencil
    ``bisect`` each taken at least once, every completed result within its
    bounds."""
    import shutil

    from repro_torch.runtime.faults import FaultConfig, FaultInjector

    t_phase = time.perf_counter()
    inj = FaultInjector(FaultConfig(p_codec=0.3, p_dispatch=0.3, p_oom=0.5, max_per_site=2), seed=7)
    read = reset_launches()
    svc, reqs, res, corrupted, secs = run_service(dev, data, SERVICE_DIR / "faults", injector=inj, **kw)
    counts = read()
    worst = check_service("service_faults", svc, reqs, res, corrupted, faults=True)
    summary = latency_summary(svc, reqs, res)
    emit("service_faults", **secs, **summary, worst_spatial_margin=worst[0], worst_frequency_margin=worst[1],
         launches={k: v for k, v in counts.items() if v}, seconds=time.perf_counter() - t_phase)
    for rung in ("fallback:packed", "fallback:xla", "bisect"):
        require(summary["rungs"].get(rung, 0) > 0, f"service_faults: no request took {rung}: {summary['rungs']}")
    launches_on_path(records, counts, "service_faults", EVEN_FIELD_KERNELS + EVEN_PENCIL_KERNELS)
    shutil.rmtree(SERVICE_DIR, ignore_errors=True)


def phase_session_recover(dev, records, frames, crash_after=2):
    """A live session's ``.wal`` after ``crash_after`` appends, recovered by
    a new ``FFCzService`` instance, which appends the rest and finalizes: the
    container bitwise ``TemporalCodec.compress_stream`` of all the frames
    (``warm_start=False``) on the card."""
    import shutil

    from repro_torch.compressors import get_compressor
    from repro_torch.core.temporal import TemporalCodec, TemporalConfig
    from repro_torch.serving import FFCzService, ServiceConfig

    shutil.rmtree(SERVICE_DIR, ignore_errors=True)
    t_phase = time.perf_counter()
    engine, cfg = pallas_engine_config(dev)
    stream = TemporalConfig(mode="field", predictor="linear", keyframe_interval=2)
    read = reset_launches()
    first = FFCzService(get_compressor("szlike"), engine=engine,
                        config=ServiceConfig(pipeline_depth=2, session_journal_dir=str(SERVICE_DIR / "a")))
    sid = first.open_session(cfg, stream, session_id="recover")
    uids = [first.submit_append(sid, t, frames[t]) for t in range(crash_after)]
    res = first.drain()
    require(all(res[u].ok for u in uids), "session_recover: an append before the crash failed")
    first.close()
    wal = (SERVICE_DIR / "a" / "recover.wal").read_bytes()
    del first  # the crash: the session is never finalized
    second = FFCzService(get_compressor("szlike"), engine=engine,
                         config=ServiceConfig(pipeline_depth=2, session_journal_dir=str(SERVICE_DIR / "b")))
    sid2 = second.sessions.recover(wal)
    next_seq = second.sessions.next_seq(sid2)
    dup = second.submit_append(sid2, crash_after - 1, frames[crash_after - 1])
    rest = [second.submit_append(sid2, t, frames[t]) for t in range(crash_after, len(frames))]
    fin = second.submit_finalize(sid2)
    res = second.drain()
    second.close()
    counts = read()
    require(next_seq == crash_after, f"session_recover: next_seq {next_seq}, want {crash_after}")
    require(res[dup].ok and res[dup].payload.duplicate and res[dup].payload.restored,
            f"session_recover: the duplicate retry answered {res[dup].payload}")
    require(all(res[u].ok for u in rest) and res[fin].ok, "session_recover: an append or the finalize failed")
    t0 = time.perf_counter()
    want = TemporalCodec(get_compressor("szlike"), cfg, stream, engine=engine).compress_stream(frames)
    compress_s = time.perf_counter() - t0
    bitwise = res[fin].payload == want
    emit("session_recover", frames=len(frames), shape=list(frames[0].shape), crash_after=crash_after,
         wal_bytes=len(wal), next_seq=next_seq, container_bytes=len(want), bitwise_equal_to_compress_stream=bitwise,
         compress_stream_seconds=compress_s, seconds=time.perf_counter() - t_phase,
         launches={k: v for k, v in counts.items() if v})
    require(bitwise, "session_recover: the recovered container differs from compress_stream's")
    launches_on_path(records, counts, "session_recover", EVEN_FIELD_KERNELS)
    shutil.rmtree(SERVICE_DIR, ignore_errors=True)


DIST_DIR = ROOT / "build" / "chip_smoke_dist"  # the process group's init file (ignored by git), removed after
# phase sharded's cases: (label, field, FFCzConfig keywords); the pspec case
# at 64^3 (CUTS)
SHARDED_CODEC = (("nyx-like-128 Delta_rel", "nyx-like-128", dict(E_rel=1e-3, Delta_rel=1e-3)),
                 ("nyx-like (64^3) pspec_rel", "nyx-like", dict(E_rel=1e-3, Delta_rel=None, pspec_rel=1e-3)))


def phase_sharded(dev, records, codec_cases=SHARDED_CODEC, spectrum_field="nyx-like-128", rows=49152,
                  block=1024, psum_values=1 << 26):
    """The port's distribution at world size 1, through the code the CPU's
    gloo ranks run: a one-rank process group (NCCL on the card, gloo on the
    CPU; file:// init under build/) and a 1-D ``DeviceMesh`` ("data",).

    - codec: ``FFCz.compress(ShardedField)`` of each case with
      ``fft_impl="packed"`` (the loop's dist mode), both stored bounds
      rechecked in float64, ``decompress_sharded`` bitwise ``decompress``;
    - backend: a pallas ``CorrectionEngine(backend="sharded")`` on ``rows``
      pencils of ``block`` (kernels 3p, 4p), bitwise the batched engine's
      corrected values, edits and per-block stats; its launches are counted
      under path "sharded", each kernel's first call held bitwise against
      its twin;
    - ``compressed_psum`` of ``psum_values`` float32 values, bitwise the
      one-device quantize-dequantize;
    - ``power_spectrum`` of a ShardedField against the unsharded one at the
      reference's bar for its own (shells within rtol 1e-4, the DC shell
      within 1e-6 of the largest: float32 shell sums re-associate).
    """
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.compressors import get_compressor
    from repro_torch.core.engine import CorrectionEngine
    from repro_torch.core.ffcz import FFCz, FFCzConfig
    from repro_torch.core.spectrum import power_spectrum
    from repro_torch.data.fields import error_pencils, make_field
    from repro_torch.kernels.rfft import ops as rfft_ops
    from repro_torch.optim import compressed_psum
    from repro_torch.optim.grad_compress import _quantize_dequantize
    from repro_torch.sharding import ShardedField

    t_phase = time.perf_counter()
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    DIST_DIR.mkdir(parents=True)
    backend = "nccl" if torch.device(dev).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(0)  # the rank's card, before the mesh (torchrun's LOCAL_RANK)
    dist.init_process_group(backend, init_method=f"file://{DIST_DIR / 'init'}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh(torch.device(dev).type, (1,), mesh_dim_names=("data",))
        emit("sharded", part="group", backend=dist.get_backend(), world_size=dist.get_world_size(),
             mesh=list(mesh.shape), mesh_dim_names=list(mesh.mesh_dim_names))

        for i, (label, name, kw) in enumerate(codec_cases):
            x = make_field(name)
            codec = FFCz(get_compressor("szlike"), FFCzConfig(fft_impl="packed", max_iters=3000, **kw), device=dev)
            if i == 0:
                # the first call pays the group's first collectives and the
                # cuFFT plans of every pass; the second is the steady state
                first = codec.compress(ShardedField.shard(x, mesh)).stats.stage_seconds
                # the single-device path on the same field: bound-class
                # (the same host-resolved E, Delta at float32 FFT rounding)
                single = codec.compress(x)
            blob = codec.compress(ShardedField.shard(x, mesh))
            t0 = time.perf_counter()
            dec = codec.decompress(blob)
            decode_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = codec.decompress_sharded(blob, mesh)
            scatter_s = time.perf_counter() - t0
            spatial, frequency = recheck(x, dec, blob)
            st = blob.stats
            bitwise = bool(np.array_equal(back.to_host(), dec))
            emit("sharded", part="codec", case=label, shape=list(x.shape), fft_impl="packed",
                 iterations=st.iterations, converged=st.converged, spatial_margin=spatial,
                 frequency_margin=frequency, stage_seconds=st.stage_seconds,
                 first_call_stage_seconds=first if i == 0 else None, decode_seconds=decode_s,
                 decompress_sharded_seconds=scatter_s, decompress_sharded_bitwise=bitwise,
                 total_bytes=st.total_bytes, pad_meta=blob.pad_meta is not None)
            require(st.converged, f"sharded {label}: POCS did not converge in {st.iterations} iterations")
            require(spatial >= 0 and frequency >= 0, f"sharded {label}: stored bound violated")
            require(bitwise, f"sharded {label}: decompress_sharded differs from decompress")
            if i == 0:
                delta_rel = abs(single.Delta_scalar - blob.Delta_scalar) / blob.Delta_scalar
                emit("sharded", part="single_device", case=label, iterations=single.stats.iterations,
                     stage_seconds=single.stats.stage_seconds, total_bytes=single.stats.total_bytes,
                     same_E=single.E == blob.E, Delta_rel_diff=delta_rel)
                require(single.stats.converged and min(recheck(x, codec.decompress(single), single)) >= 0,
                        f"sharded {label}: the single-device blob misses its bounds")
                require(single.E == blob.E and delta_rel <= 1e-6,
                        f"sharded {label}: bounds resolved off the single-device plan's")

        errs, Es, Ds = error_pencils(dev, rows, block)
        batched = CorrectionEngine(backend="batched", fft_impl="pallas", device=dev)
        engine = CorrectionEngine(backend="sharded", fft_impl="pallas", mesh=mesh)
        batched.correct(errs, Es, Ds, block=block)  # warm-up: cuFFT plans
        sync(dev)
        t0 = time.perf_counter()
        want = batched.correct(errs, Es, Ds, block=block, return_edits=True)
        sync(dev)
        batched_s = [time.perf_counter() - t0]
        captured, undo = first_calls((rfft_ops, PENCIL_WRAPPERS))
        read = reset_launches()
        try:
            t0 = time.perf_counter()
            got = engine.correct(errs, Es, Ds, block=block, return_edits=True)
            sync(dev)
            sharded_s = time.perf_counter() - t0
        finally:
            undo()
        counts = read()
        launches_on_path(records, counts, "sharded")
        hold_at_path_shapes("sharded", records, captured)
        del captured
        timed = []
        for eng in (engine, batched):  # in turns: batched, sharded, sharded, batched
            sync(dev)
            t0 = time.perf_counter()
            eng.correct(errs, Es, Ds, block=block, return_edits=True)
            sync(dev)
            timed.append(time.perf_counter() - t0)
        sharded_s = [sharded_s, timed[0]]
        batched_s.append(timed[1])
        (c_got, e_got, s_got), (c_want, e_want, s_want) = got, want
        pairs = list(zip(c_got, c_want)) + [(a, b) for eg, ew in zip(e_got, e_want) for a, b in zip(eg, ew)]
        pairs += [(getattr(s_got, k), getattr(s_want, k))
                  for k in ("iterations", "converged", "block_iterations", "block_converged")]
        bitwise = all(same(a, b) for a, b in pairs)
        iters = s_want.block_iterations.cpu().numpy()
        emit("sharded", part="backend", fft_impl="pallas", block=block, pencils=int(iters.size),
             values=sum(e.numel() for e in errs), batched_seconds=batched_s, sharded_seconds=sharded_s,
             iterations_histogram={int(k): int(v) for k, v in zip(*np.unique(iters, return_counts=True))},
             converged=bool(s_want.converged.all()), bitwise_vs_batched=bitwise,
             launches={k: v for k, v in counts.items() if v})
        require(bool(s_want.converged.all()), "sharded backend: a pencil did not converge")
        require(int(iters.max()) > 1, "sharded backend: no pencil needed correcting")
        require(bitwise, "sharded backend: results differ from the batched backend")
        del errs, got, want, pairs

        gen = torch.Generator(device=dev).manual_seed(6)
        g = torch.randn(psum_values, generator=gen, device=dev)
        psum_s = []
        for _ in range(3):  # the first call's all-reduces are the group's first of their kind
            sync(dev)
            t0 = time.perf_counter()
            total = compressed_psum(g, mesh)
            sync(dev)
            psum_s.append(time.perf_counter() - t0)
        want = _quantize_dequantize(g, 8, 1e-2)[0]
        sync(dev)
        t0 = time.perf_counter()
        _quantize_dequantize(g, 8, 1e-2)
        sync(dev)
        quantize_s = time.perf_counter() - t0
        bitwise = same(total, want)
        emit("sharded", part="compressed_psum", values=psum_values, seconds=psum_s,
             one_device_quantize_seconds=quantize_s, bitwise_vs_quantize=bitwise,
             max_abs_err=float((total - want).abs().max()))
        require(bitwise, "compressed_psum differs from the one-device quantize-dequantize")
        del g, total, want

        x = make_field(spectrum_field)
        field = ShardedField.shard(x, mesh)
        spec_s = []
        for _ in range(2):  # the first call builds the passes' cuFFT plans
            sync(dev)
            t0 = time.perf_counter()
            _, got = power_spectrum(field)
            sync(dev)
            spec_s.append(time.perf_counter() - t0)
        x_dev = torch.from_numpy(x).to(dev)
        power_spectrum(x_dev)
        sync(dev)
        t0 = time.perf_counter()
        _, want = power_spectrum(x_dev)
        sync(dev)
        single_s = time.perf_counter() - t0
        got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
        # the reference's bar for its sharded spectrum: shells 1.. within
        # rtol 1e-4, shell 0 (the mean-normalized DC, ~0) within 1e-6 of the
        # largest shell
        rel = float(np.max(np.abs(got[1:] - want[1:]) / want[1:]))
        dc = float(abs(got[0]) / want[1:].max())
        emit("sharded", part="power_spectrum", field=spectrum_field, seconds=spec_s, single_device_seconds=single_s,
             shells=int(want.size), max_rel_shell_diff=rel, dc_over_largest_shell=dc)
        require(rel <= 1e-4 and dc <= 1e-6, f"power_spectrum_sharded off power_spectrum: shells {rel:.3g}, DC {dc:.3g}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(DIST_DIR, ignore_errors=True)
    emit("sharded", part="summary", seconds=time.perf_counter() - t_phase,
         launches_by_path={k: records[k]["launches_by_path"]["sharded"] for k in EVEN_PENCIL_KERNELS})


def same_state(mesh_params, one_params):
    """Every parameter of a mesh Trainer's (its one rank's shards, whole)
    bitwise the one-device model's; returns the names that differ."""
    return [k for k, v in one_params.items() if not same(mesh_params[k], v)]


def phase_train_mesh(dev, records, cfg=None, tokens=(4, 2048), grad_Delta_rel=5e-5, steps=2):
    """Training over a data mesh at world size 1: ``Trainer(mesh=
    make_mesh((1, 1), ("data", "model")))`` on a one-rank process group
    (NCCL on the card, gloo on the CPU; file:// init under build/), the code
    the CPU tests run on 2 and 4 gloo ranks (FSDP placements from the rules,
    the segment-wise step, the gradients compressed over the mesh through a
    pallas engine: kernels 3p/4p).  ``cfg``: phase train's (qwen2-0.5b at
    full width, TRAIN_LAYERS layers), ``tokens`` a step, ``steps`` steps.

    Gate: the loss of every step and every parameter after the last equal,
    bitwise, a one-device Trainer's steps with the same engine from the
    same seed; one ulp planted in one shard must miss that gate.  The
    kernels' launches on this path are counted (path "train_mesh") and their
    first calls held bitwise against the twins.  Reported: step seconds,
    ``compress_sharded_gradients`` seconds, the rank's peak memory and the
    bytes of state it holds against the rules' share."""
    import dataclasses
    import math
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.engine import CorrectionEngine
    from repro_torch.kernels.rfft import ops as rfft_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import grad_compress
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.sharding import tp

    t_phase = time.perf_counter()
    cfg = cfg or get_config("qwen2-0.5b", n_layers=TRAIN_LAYERS)
    cfg = dataclasses.replace(cfg, compression=dataclasses.replace(
        cfg.compression, grad_compression=True, grad_Delta_rel=grad_Delta_rel))
    engine = CorrectionEngine(fft_impl="pallas", device=dev)
    run = dict(seq_len=tokens[1], global_batch=tokens[0], ckpt_every=10**6, log_every=1)
    shutil.rmtree(WORK_DIR, ignore_errors=True)

    # the one-device steps (the step function phase train's Trainer runs)
    one = Trainer(cfg, TrainerConfig(ckpt_dir=str(WORK_DIR / "one"), **run), device=dev, engine=engine)
    one_losses, one_s = [], []
    for i in range(steps):
        batch = one.pipeline.batch_at(i)
        sync(dev)
        t0 = time.perf_counter()
        one.params, one.opt_state, loss = one._step(one.params, one.opt_state, batch)
        one_losses.append(loss)
        sync(dev)
        one_s.append(time.perf_counter() - t0)
    want = {k: v.detach().clone() for k, v in one.params.state_dict().items()}
    del one
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()

    shutil.rmtree(DIST_DIR, ignore_errors=True)
    DIST_DIR.mkdir(parents=True)
    backend = "nccl" if torch.device(dev).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{DIST_DIR / 'init'}", rank=0, world_size=1)
    compress_s = []
    timed_fn = grad_compress.compress_sharded_gradients

    def timed(*a, **kw):
        sync(dev)
        t = time.perf_counter()
        out = timed_fn(*a, **kw)
        sync(dev)
        compress_s.append(time.perf_counter() - t)
        return out

    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        if torch.device(dev).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = Trainer(cfg, TrainerConfig(ckpt_dir=str(WORK_DIR / "mesh"), **run), mesh=mesh, engine=engine)
        init_s = time.perf_counter() - t0
        held = trainer.layout.state_bytes(trainer.params) + trainer.layout.state_bytes(trainer.opt_state)
        captured, undo = first_calls((rfft_ops, PENCIL_WRAPPERS))
        read = reset_launches()
        grad_compress.compress_sharded_gradients = timed
        entered, context = [], tp.context
        tp.context = lambda ctx: entered.append(ctx) or context(ctx)  # the segments' TP context
        try:
            out = trainer.train(steps)
        finally:
            grad_compress.compress_sharded_gradients = timed_fn
            tp.context = context
            undo()
        counts = read()
        peak = torch.cuda.max_memory_allocated() if torch.device(dev).type == "cuda" else 0
        launches_on_path(records, counts, "train_mesh")
        hold_at_path_shapes("train_mesh", records, captured)
        del captured
        losses = [m["loss"] for m in out["metrics"]]
        one_floats = [float(v) for v in one_losses]
        differ = same_state(trainer.params, want)
        # the planted fault: one ulp in one shard
        leaf = "layers.0.attn.wqkv"
        faulty = dict(trainer.params)
        t = faulty[leaf].clone()
        bits = t.view({2: torch.int16, 4: torch.int32}[t.element_size()]).view(-1)
        bits[0] += 1  # the next representable magnitude: one ulp
        faulty[leaf] = t
        fault_differ = same_state(faulty, want)
        step_s = [m["dt"] for m in out["metrics"]]
        emit("train_mesh", config=cfg.name, n_layers=cfg.n_layers, tokens=list(tokens), world_size=1,
             backend=dist.get_backend(), mesh=list(mesh.shape), mesh_dim_names=list(mesh.mesh_dim_names),
             fft_impl="pallas", grad_Delta_rel=grad_Delta_rel, init_seconds=init_s, step_seconds=step_s,
             one_device_step_seconds=one_s,
             compress_sharded_gradients_seconds=compress_s, losses=losses, one_device_losses=one_floats,
             losses_bitwise=losses == one_floats, params_differing=differ, params=len(want),
             planted_fault=f"one ulp in {leaf}[0]", planted_fault_differing=fault_differ,
             state_bytes_held=held, rules_share_bytes=trainer.layout.share_bytes(), peak_memory_gb=peak / 1e9,
             tp_context_entries=len(entered), tp_model_size=trainer.layout.tp_ctx.size,
             launches={k: v for k, v in counts.items() if v})
        require(all(map(math.isfinite, losses)), "train_mesh: a loss is not finite")
        require(bool(entered) and all(c is trainer.layout.tp_ctx for c in entered),
                f"train_mesh: the segments ran outside the mesh's TP context ({len(entered)} entries)")
        require(losses == one_floats, f"train_mesh: losses {losses} differ from the one-device steps' {one_floats}")
        require(not differ, f"train_mesh: {len(differ)} parameters differ from the one-device steps', e.g. {differ[:3]}")
        require(fault_differ == [leaf], f"train_mesh: the planted fault was not caught: {fault_differ}")
        require(held == trainer.layout.share_bytes(), f"train_mesh: holds {held} bytes, the rules' share is "
                f"{trainer.layout.share_bytes()}")
        del trainer, faulty, want
    finally:
        dist.destroy_process_group()
        shutil.rmtree(DIST_DIR, ignore_errors=True)
        shutil.rmtree(WORK_DIR, ignore_errors=True)
    emit("train_mesh", part="summary", seconds=time.perf_counter() - t_phase,
         launches_by_path={k: records[k]["launches_by_path"]["train_mesh"] for k in EVEN_PENCIL_KERNELS})


def phase_serve_mesh(dev, records, cfg=None, rows=4, prompt=2048, new=2):
    """Serving over a mesh at world size 1: ``make_step`` prefill and decode
    (``MeshServe``) on ``make_mesh((1, 1), ("data", "model"))`` over a
    one-rank process group, the code the CPU tests run with "model" axes of
    2 and 4 (the rules' placements, each layer's parameters gathered by a
    hook, the mesh's TP context, a cache from ``MeshServe.init_cache``).
    ``cfg``: qwen2-0.5b at full width and depth, bf16, ``attention_impl=
    "pallas"`` (the prefill runs the flash kernel), random weights from seed
    0; ``rows`` prompts of ``prompt`` tokens, then ``new`` decode steps.

    Gate: every step's logits bitwise the one-device bundle's on the same
    weights and tokens; the flash kernel launched (path "serve_mesh": one a
    layer, in the prefill) and its first call held against the twin (bf16:
    one ulp at each element's magnitude, 3e-5 floor).  Reported: prefill and
    decode seconds, the state and cache bytes a rank holds."""
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.sharding.fsdp import init_shards

    t_phase = time.perf_counter()
    cfg = cfg or get_config("qwen2-0.5b", attention_impl="pallas")
    gen = torch.Generator(device=dev).manual_seed(7)
    toks = torch.randint(0, cfg.vocab, (rows, prompt + new), generator=gen, device=dev, dtype=torch.int64)

    def serve(step_prefill, step_decode, params, cache):
        sync(dev)
        t0 = time.perf_counter()
        logits, cache = step_prefill(params, {"tokens": toks[:, :prompt]}, cache)
        out = [logits.clone()]
        sync(dev)
        t1 = time.perf_counter()
        for t in range(prompt, prompt + new):
            logits, cache = step_decode(params, toks[:, t : t + 1], cache)
            out.append(logits.clone())
        sync(dev)
        return out, t1 - t0, time.perf_counter() - t1, cache

    bundle = build_model(cfg, device=dev)
    one = bundle.init(torch.Generator(device=dev).manual_seed(0))
    want, one_prefill_s, one_decode_s, _ = serve(bundle.prefill, bundle.decode, one,
                                                 bundle.init_cache(rows, prompt + new + 1))
    del one, bundle
    torch.cuda.empty_cache()

    shutil.rmtree(DIST_DIR, ignore_errors=True)
    DIST_DIR.mkdir(parents=True)
    backend = "nccl" if torch.device(dev).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{DIST_DIR / 'init'}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        pre, _args, _in, out_sh = steps_mod.make_step(cfg, "prefill_32k", mesh)
        dec = steps_mod.make_step(cfg, "decode_32k", mesh)[0]
        L = pre.layout
        params = init_shards(L, torch.Generator(device=dev).manual_seed(0))
        cache = pre.init_cache(rows, prompt + new + 1)
        captured, undo = first_calls((flash_ops, ("flash_attention",)))
        read = reset_launches()
        try:
            got, prefill_s, decode_s, cache = serve(pre, dec, params, cache)
        finally:
            undo()
        counts = read()
        bitwise = [bool(torch.equal(g, w)) for g, w in zip(got, want)]
        diffs = [float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)]
        n_flash = counts["flash_attention"]
        flash = records["flash_attention"]
        flash["launches"] += n_flash
        flash.setdefault("launches_by_path", {})["serve_mesh"] = n_flash

        # the kernel against its twin at the path's first shape (outside the count)
        (name, shape), (ops, args, kw) = next(iter(captured.items()))

        def replay():
            read_one = reset_launches()
            kernel = getattr(ops, name)(*args, **kw)
            return kernel, read_one()["flash_attention"]

        kernel, replay_launches = without_counting(replay)
        ok, ulps, n_over, worst = bf16_within_one_ulp(kernel, attention_ref(*args, **kw))
        flash.setdefault("shapes_held_on_paths", {}).setdefault("serve_mesh", []).append(list(shape))
        held = L.state_bytes(params)
        emit("serve_mesh", config=cfg.name, n_layers=cfg.n_layers, dtype=cfg.dtype, rows=rows, prompt=prompt,
             decode_steps=new, world_size=1, backend=dist.get_backend(), mesh=list(mesh.shape),
             logits_placements=[repr(p) for p in out_sh[0]], logits_shape=list(got[0].shape),
             logits_bitwise=bitwise, max_abs_diff=diffs, prefill_seconds=prefill_s, decode_seconds=decode_s,
             one_device_prefill_seconds=one_prefill_s, one_device_decode_seconds=one_decode_s,
             state_bytes_held=held, rules_share_bytes=L.share_bytes(moments=False),
             cache_bytes=L.state_bytes(cache), launches={k: v for k, v in counts.items() if v},
             flash_held={"shape": list(shape), "launches": replay_launches, "within_one_ulp": ok,
                         "max_ulps": ulps, "n_over_one_ulp": n_over, "largest_value_over_one_ulp": worst})
        require(all(bitwise), f"serve_mesh: logits differ from the one-device bundle's by {diffs}")
        require(n_flash == cfg.n_layers, f"serve_mesh: {n_flash} flash_attention launches, want {cfg.n_layers}")
        require(replay_launches == 1, f"serve_mesh: the held call launched {replay_launches} kernels, want one")
        require(ok, f"serve_mesh: flash_attention at {shape} is more than one ulp + 3e-5 from its twin")
        require(held == L.share_bytes(moments=False), f"serve_mesh: holds {held} bytes, the rules' share is "
                f"{L.share_bytes(moments=False)}")
        del params, cache, got, captured
    finally:
        dist.destroy_process_group()
        shutil.rmtree(DIST_DIR, ignore_errors=True)
    emit("serve_mesh", part="summary", seconds=time.perf_counter() - t_phase,
         launches_by_path={"flash_attention": records["flash_attention"]["launches_by_path"]["serve_mesh"]})


def recheck(x, dec, blob):
    """Float64 margins of ``dec`` against the bounds ``blob`` STORES."""
    import numpy as np

    from repro_torch.core.cubes import rfft_shape

    eps = dec.astype(np.float64) - np.asarray(x, np.float32).astype(np.float64)
    if blob.roi_bound is not None:
        E = np.frombuffer(blob.roi_bound, np.float32).reshape(blob.shape).astype(np.float64)
    else:
        E = blob.E
    d = np.fft.rfftn(eps)
    if blob.pointwise_delta is not None:
        D = np.frombuffer(blob.pointwise_delta, np.float32).reshape(rfft_shape(blob.shape))
        D = D.astype(np.float64)
    else:
        D = blob.Delta_scalar
    spatial = float(np.min(E - np.abs(eps)))
    frequency = float(np.min(D - np.maximum(np.abs(d.real), np.abs(d.imag))))
    return spatial, frequency


def run_case(phase, label, x, cfg, dev, must_launch, keep=None):
    """Drive compress + decompress once with the launch counts zeroed just
    before and read just after; recheck the stored bounds in float64.
    ``keep`` (a dict) receives the EXECUTE result's spatial edits."""
    from repro_torch.compressors import get_compressor
    from repro_torch.core.ffcz import FFCz

    codec = FFCz(get_compressor("szlike"), cfg, device=dev)
    if keep is not None:
        encode = codec.engine.encode_field

        def recording(result, plan):
            keep.update(spat=result.spat, E=plan.E)
            return encode(result, plan)

        codec.engine.encode_field = recording  # the shared default engine: restored below
    read = reset_launches()
    try:
        blob = codec.compress(x)
    finally:
        if keep is not None:
            del codec.engine.encode_field
    t0 = time.perf_counter()
    dec = codec.decompress(blob)
    decode_s = time.perf_counter() - t0
    counts = read()
    spatial, frequency = recheck(x, dec, blob)
    st = blob.stats
    emit(phase, case=label, shape=list(x.shape), iterations=st.iterations, converged=st.converged,
         spatial_margin=spatial, frequency_margin=frequency, stage_seconds=st.stage_seconds,
         decode_seconds=decode_s, launches=counts, total_bytes=st.total_bytes,
         n_active_spatial=st.n_active_spatial, n_active_frequency=st.n_active_frequency)
    require(dec.shape == tuple(x.shape) and bool((dec == dec).all()), f"{label}: bad decode")
    require(st.converged, f"{label}: POCS did not converge in {st.iterations} iterations")
    require(spatial >= 0 and frequency >= 0, f"{label}: stored bound violated")
    for k in must_launch:
        require(counts[k] > 0, f"{label}: kernel {k} never launched on the main path")
    return counts, st.iterations


def compare_lm(other: Path) -> int:
    """Phase lm_family on qwen2-0.5b of checkout ``other`` (its chip_smoke.py
    must have ``phase_lm_family``) and of this one, alternated other, this, this,
    other; each run prints its own ``lm_family`` lines."""
    run = ("import sys, torch; root = sys.argv[1]; sys.path[:0] = [root, root + '/src']\n"
           "import chip_smoke\nfrom repro_torch.kernels import build\n"
           "torch.backends.cuda.matmul.allow_tf32 = False\ntorch.backends.cudnn.allow_tf32 = False\n"
           "build.build_all()\nrecords = {k: {'launches': 0} for k in chip_smoke.KERNEL_ROWS}\n"
           "chip_smoke.phase_lm_family('cuda', records, 'qwen2-0.5b')\n")
    for root in (other.resolve(), ROOT, ROOT, other.resolve()):
        emit("compare_lm", root=str(root))
        subprocess.run([sys.executable, "-c", run, str(root)], check=True, timeout=900)
    return 0


def decode_sweep() -> int:
    """The readings CHECK_DEPTH was chosen from: mamba2-2.7b and zamba2-7b
    at full width in bf16 (weights from seed 0) at several depths, each
    with the served decode's distance from a cache-less forward, the floor
    between the two cache-less forwards, and one decode step after an
    aligned prefill without and with the SSM states zeroed (cache_fault)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.model import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", nvidia_smi=nvidia_smi_line())
    build.build_all()
    for arch, depths in (("mamba2-2.7b", (4, 8, 16, 24, 32, 48, 64)), ("zamba2-7b", (6, 12, 18, 24, 36, 81))):
        for layers in depths:
            cfg = get_config(arch, attention_impl="pallas", n_layers=layers)
            _, requests = lm_requests(cfg, (4, 600))
            params = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
            served = serve_and_check(cfg, params, requests[:4], "cuda")
            leaf, clean, faulty = cache_fault(cfg, params, served, "cuda")
            emit("decode_sweep", arch=arch, layers=layers, served_decode_max_abs=served["diff"],
                 cacheless_floor_max_abs=served["floor"], logit_scale=served["scale"],
                 planted_fault=f"zeroed {leaf}", fault_free_step_max_abs=clean, faulty_step_max_abs=faulty)
            del params
            torch.cuda.empty_cache()
    return 0


def train_families(dev, records):
    """Phase train_family on each arch of TRAIN_FAMILIES, then its summary."""
    import torch

    summaries = []
    for arch in TRAIN_FAMILIES:
        summaries.append(phase_train_family(dev, records, arch, tokens=TRAIN_FAMILIES[arch][1],
                                            resume_layers=RESUME_LAYERS[arch]))
        torch.cuda.empty_cache()
    emit("train_family", part="summary", families=summaries, seconds=sum(s["seconds"] for s in summaries))


def train_families_only() -> int:
    """Build the kernels and run phase train_family alone (its gates too)."""
    import torch

    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", nvidia_smi=nvidia_smi_line())
    emit("build", seconds=build.build_all())
    records = {k: {"name": k, "launches": 0} for k in KERNEL_ROWS}
    train_families("cuda", records)
    emit("train_family", part="launches", launches={k: r.get("launches_by_path", {}) for k, r in records.items()})
    return 0


def sharded_only() -> int:
    """Build the kernels and run phase sharded alone (its gates too)."""
    import torch

    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", nvidia_smi=nvidia_smi_line())
    emit("build", seconds=build.build_all())
    records = {k: {"name": k, "launches": 0} for k in KERNEL_ROWS}
    phase_sharded("cuda", records)
    return 0


def train_mesh_only() -> int:
    """Build the kernels and run phases train_mesh and serve_mesh alone
    (their gates too)."""
    import torch

    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", nvidia_smi=nvidia_smi_line())
    emit("build", seconds=build.build_all())
    records = {k: {"name": k, "launches": 0} for k in KERNEL_ROWS}
    phase_train_mesh("cuda", records)
    phase_serve_mesh("cuda", records)
    return 0


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--compare-lm"] and len(sys.argv) == 3:
        return compare_lm(Path(sys.argv[2]))
    if sys.argv[1:] == ["--decode-sweep"]:
        return decode_sweep()
    if sys.argv[1:] == ["--train-families"]:
        return train_families_only()
    if sys.argv[1:] == ["--sharded"]:
        return sharded_only()
    if sys.argv[1:] == ["--train-mesh"]:
        return train_mesh_only()
    if sys.argv[1:]:
        print("usage: chip_smoke.py [--compare-lm OTHER_CHECKOUT | --decode-sweep | --train-families | --sharded "
              "| --train-mesh]", file=sys.stderr)
        return 2

    from repro_torch.compressors import get_compressor
    from repro_torch.core.ffcz import FFCz, FFCzBlob, FFCzConfig
    from repro_torch.data.fields import make_field
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = "cuda"
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda, cuts=CUTS)

    emit("build", seconds=build.build_all(), nvcc=build.nvcc(), flags=list(build.NVCC_FLAGS))

    records = phase_kernels(dev)

    # 4: the main path, even last axis — the fused epilogues (kernels 3, 4)
    x = make_field("nyx-like-256")
    cfg = FFCzConfig(E_rel=1e-3, Delta_rel=1e-3, fft_impl="pallas", max_iters=3000)
    edits = {}
    counts, iters = run_case("even", "nyx-like-256 Delta_rel", x, cfg, dev,
                             ("rfft_fwd_epilogue", "unpack_sclip"), keep=edits)
    for k in ("rfft_fwd_epilogue", "unpack_sclip"):
        records[k]["launches"] = counts[k]
        records[k]["launches_per_iteration"] = counts[k] / iters

    # 5: odd last axis — the static fallback to the fcube/scube kernels
    x_odd = np.ascontiguousarray(x[..., :255])
    counts, iters = run_case("odd", "nyx-like-256[..., :255] Delta_rel", x_odd, cfg, dev,
                             ("fcube", "scube"))
    for k in ("fcube", "scube"):
        records[k]["launches"] = counts[k]
        records[k]["launches_per_iteration"] = counts[k] / iters

    # 6: pointwise bounds — Delta_k grid (pspec) and an E_n grid (ROI mask)
    run_case("pointwise", "nyx-like (64^3) pspec_rel", make_field("nyx-like"),
             FFCzConfig(E_rel=1e-3, Delta_rel=None, pspec_rel=1e-3, fft_impl="pallas", max_iters=3000),
             dev, ("rfft_fwd_epilogue", "unpack_sclip"))
    x128 = make_field("nyx-like-128")
    mask = np.zeros(x128.shape, dtype=bool)
    mask[32:96, 32:96, 32:96] = True
    run_case("pointwise", "nyx-like-128 E_roi", x128,
             FFCzConfig(E_rel=1e-3, Delta_rel=1e-3, E_roi=mask, fft_impl="pallas", max_iters=3000),
             dev, ("rfft_fwd_epilogue", "unpack_sclip"))

    # 7: golden fixtures written by the reference package decode bitwise
    data = ROOT / "tests" / "data"
    codec = FFCz(get_compressor("szlike"), FFCzConfig(E_rel=1e-3, Delta_rel=1e-3), device=dev)
    for blob_name, out_name in (("legacy_blob_v0.bin", "legacy_blob_v0_output.npy"),
                                ("padfree_v1_blob.bin", "padfree_v1_output.npy"),
                                ("uneven_v1_blob.bin", "uneven_v1_output.npy")):
        got = codec.decompress(FFCzBlob.from_bytes((data / blob_name).read_bytes()))
        want = np.load(data / out_name)
        require(got.dtype == want.dtype and np.array_equal(got, want), f"golden {blob_name} differs")
        emit("golden", blob=blob_name, bitwise=True)

    # QuantizeEdits and the zfplike block transform, through their public ops
    records["quantize"] = phase_quantize(dev, edits["spat"], edits["E"])
    records["block_transform"] = phase_block_transform(dev, x)
    del edits

    # 8: the flash kernel, at qwen2-0.5b's shapes and at the families'
    # attention shapes (head dim 112: zamba2-7b), and the per-pencil kernels
    sass, ptxas = flash_build_report()
    emit("lm", part="flash_build", sass=sass, ptxas=ptxas)
    require(sass["HGMMA"] > 0, "flash_attention: no HGMMA (wgmma) in the library's SASS")
    require(sass["UTMALDG"] + sass["UBLKCP"] > 0, "flash_attention: no TMA load in the library's SASS")
    require(no_spills(ptxas, 6), f"flash_attention: ptxas reports spills or misses a kernel: {ptxas}")
    records["flash_attention"] = phase_flash(dev)
    phase_flash_families(dev, records["flash_attention"])
    records.update(phase_pencil_kernels(dev))

    # the port's distribution at world size 1: the sharded codec, the
    # sharded pencil backend through kernels 3p/4p, compressed_psum and the
    # sharded power spectrum, on a one-rank NCCL group
    phase_sharded(dev, records)

    # the LM families at full width; the pencil path (KV-cache compression)
    # on the dense model's cache
    families = []
    for arch in FAMILIES:
        tokens, prompts = LM_SHAPES.get(arch, ((4, 2048), (4, 600)))
        cfg_lm, params, summary = phase_lm_family(dev, records, arch, tokens=tokens, prompts=prompts)
        if cfg_lm.family == "dense":
            phase_pencils(dev, records, cfg_lm, params)
        del params
        torch.cuda.empty_cache()
        families.append(summary)
    emit("lm_family", part="summary", families=families)

    # the training path: Trainer with compressed gradients, failure and
    # resume; one step's gradients through the pallas engine; an FFCz
    # checkpoint through the pallas engine, restored by a new Trainer
    from repro_torch.configs import get_config

    trainer = phase_train(dev, cfg=get_config("qwen2-0.5b", n_layers=TRAIN_LAYERS))
    phase_grad_pallas(dev, records, trainer)
    del trainer
    torch.cuda.empty_cache()
    # the same training over a mesh (world size 1, one-rank NCCL group), and
    # serving through MeshServe there
    phase_train_mesh(dev, records)
    torch.cuda.empty_cache()
    phase_serve_mesh(dev, records)
    torch.cuda.empty_cache()
    phase_checkpoint(dev, records, cfg=get_config("whisper-tiny"), tokens=CHECKPOINT_TOKENS, n_layers=None)
    train_families(dev, records)

    # the service path: temporal streams (field frames, EEG pencils), the
    # FFCz service without and with injected faults, a recovered session
    phase_stream_field(dev, records)
    phase_stream_eeg(dev, records)
    data = service_data()
    phase_service(dev, records, data)
    phase_service_faults(dev, records, data)
    phase_session_recover(dev, records, data["session"])
    del data

    # 9: summary
    kernels = [records[k] for k in KERNEL_ROWS]
    for r in kernels:
        require(r["launches"] > 0, f"{r['name']} has no launches on the main path")
    emit("summary", seconds=time.perf_counter() - t_start,
         kernels=[{"name": r["name"], "launches": r["launches"], "ok": True} for r in kernels])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        emit("failed", error=str(e))
        sys.exit(1)
