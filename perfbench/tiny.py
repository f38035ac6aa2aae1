"""A copy of the benchmark at a size the CPU runs in seconds, for the tests.

:func:`make` writes, under a directory, a ``BENCHMARK.json`` whose cells
are the real ones at tiny sizes, beside copies of the real input
generators, entries, metric readers and limits: the tests drive
``run.run_cell`` on it with the port's CPU twins.  Nothing here knows a
cell: a configuration that names an ``"arch"`` takes that arch's smoke
sizes (``repro_torch.configs.get_smoke_config``) for every whole number it
states, and a configuration or a mix may carry a ``"tiny"`` block of
values of its own that replace its top-level ones at this size.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

from perfbench.spec import HERE

COPIED = ("inputs", "entries", "metrics", "limits")


def config(full: dict) -> dict:
    """``full`` at the tiny size."""
    out = dict(full)
    if "arch" in full:
        from repro_torch.configs import get_smoke_config

        smoke = dataclasses.asdict(get_smoke_config(full["arch"]))
        out.update({k: v for k, v in smoke.items()
                    if k in full and isinstance(v, int) and not isinstance(v, bool)})
    out.update(full.get("tiny", {}))
    return out


def traffic(full: dict) -> dict:
    """``full`` at the tiny size."""
    return {**full, **full.get("tiny", {})}


def make(where: Path) -> Path:
    """The tiny benchmark under ``where``; returns its ``BENCHMARK.json``."""
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    root = Path(where) / "perfbench"
    for d in COPIED:
        shutil.copytree(HERE / d, root / d)
    (root / "configs").mkdir()
    (root / "traffic").mkdir()
    for c in bench["configs"]:
        full = json.loads((HERE.parent / c["file"]).read_text())
        (root / "configs" / Path(c["file"]).name).write_text(json.dumps(config(full)))
    for w in bench["workloads"]:
        full = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        (root / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(traffic(full)))
    path = Path(where) / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path
