"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the repository root; ``perfbench/README.md`` says how
cells, configurations, traffic mixes, entries and metrics are added.
"""
