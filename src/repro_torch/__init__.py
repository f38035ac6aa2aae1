"""repro_torch — FFCz on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch port of the ``repro`` package: the whole-field codec
(``FFCz.compress`` / ``FFCz.decompress``), the batched pencil path, and the
LM framework FFCz is built into (the dense qwen2 model, serving with KV-cache
compression, training with compressed gradients and checkpoints).  Module
names mirror ``repro``'s one to one; the package imports ``torch`` and
``numpy`` only.

Layers:
  core/         bounds, cubes, the POCS loop, the correction engine, the codec.
  kernels/      every Pallas kernel of the reference as CUDA C++ for
                ``sm_90a`` (sources in ``csrc/``, built at first use): the
                POCS loop's clips and epilogues (whole field and per pencil),
                QuantizeEdits, the zfplike block transform and flash
                attention, each with a plain PyTorch twin that CPU tensors take.
  compressors/  error-bounded base compressors (numpy, host).
  coding/       entropy coding, bit packing, quantizers (numpy, host).
  models/       the dense LM (layers, attention, blocks, bundles).
  optim/        AdamW + FFCz-compressed gradients.
  checkpoint/   atomic checkpoints, optionally FFCz-compressed.
  runtime/      the fault-tolerant trainer; elastic mesh re-planning.
  sharding/     the slab-decomposed rFFT over torch.distributed
                (``ShardedField``): whole fields sharded across ranks.
  serving/      batched decode with FFCz KV-cache compression.
  launch/       step functions and the train / serve entry points.
  data/, configs/  token pipeline, synthetic science fields, arch configs.
  convert.py    state carried between the reference and the port.

Devices are explicit: entry points take ``device=None`` meaning ``"cuda"``,
and raise when no card is present rather than falling back to the CPU.
"""

__version__ = "0.1.0"
