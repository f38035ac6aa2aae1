"""repro_torch — FFCz on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch port of the ``repro`` package's whole-field codec path
(``FFCz.compress`` / ``FFCz.decompress``).  Module names mirror ``repro``'s
one to one; the package imports ``torch`` and ``numpy`` only.

Layers:
  core/         bounds, cubes, the POCS loop, the correction engine, the codec.
  kernels/      the POCS loop's four fused kernels: CUDA C++ for ``sm_90a``
                (sources in ``csrc/``, built at first use), each with a plain
                PyTorch twin that CPU tensors take.
  compressors/  error-bounded base compressors (numpy, host).
  coding/       entropy coding, bit packing, quantizers (numpy, host).
  data/, configs/  synthetic science fields.

Devices are explicit: entry points take ``device=None`` meaning ``"cuda"``,
and raise when no card is present rather than falling back to the CPU.
"""

__version__ = "0.1.0"
