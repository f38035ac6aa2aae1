"""Finding a cell's parts by name.

``BENCHMARK.json`` names each cell's configuration, traffic mix and
metrics; the files live under this folder:

- ``configs/``: each configuration's file, as ``BENCHMARK.json`` names it;
- ``traffic/<mix>.json``: a mix's parameters;
- ``inputs/<kind>.py``: the generator of the inputs that a configuration's
  ``"inputs"`` names (a function ``make``, see ``generate.py``);
- ``entries/<entry>.py``: the adapter to a program entry that a
  configuration's ``"entry"`` names (a class ``Entry``);
- ``metrics/<metric>.py``: each metric's reader (a function ``read``);
- ``limits/<cell>.json``: the limit of each number that decides a cell's
  ``correct``.

Nothing here knows a cell, a configuration, a mix or a metric by name.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """``BENCHMARK.json`` and the folder that holds the benchmark's files
    (``root``: this folder unless a test gives another)."""

    def __init__(self, benchmark: Path, root: Path = HERE):
        self.path = Path(benchmark)
        self.data = _json(self.path)
        self.root = Path(root)

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.path}")

    def config(self, cell: dict) -> dict:
        for c in self.data["configs"]:
            if c["name"] == cell["config"]:
                return _json(self.path.parent / c["file"])
        raise KeyError(f"no config {cell['config']!r} in {self.path}")

    def traffic(self, cell: dict) -> dict:
        return _json(self.root / "traffic" / f"{cell['traffic']}.json")

    def limits(self, cell: dict) -> dict:
        return _json(self.root / "limits" / f"{cell['name']}.json")

    def inputs(self, config: dict) -> ModuleType:
        return _module(self.root / "inputs" / f"{config['inputs']}.py")

    def entry(self, config: dict) -> ModuleType:
        return _module(self.root / "entries" / f"{config['entry']}.py")

    def metric(self, name: str) -> ModuleType:
        return _module(self.root / "metrics" / f"{name}.py")

    def metrics(self, cell: dict, trace: bool) -> List[dict]:
        """The cell's end-to-end metrics, or with ``trace`` its per-layer
        ones: those that list it, and those without a list whose end-to-end
        metric the cell reports."""
        def listed(m):
            return cell["name"] in m["workloads"] if "workloads" in m else None

        e2e = [m for m in self.data["end_to_end"] if listed(m) is not False]
        if not trace:
            return e2e
        reported = {m["name"] for m in e2e}
        return [m for m in self.data["per_layer"]
                if listed(m) or (listed(m) is None and m["moves"] in reported)]


def _module(path: Path) -> ModuleType:
    name = "perfbench._loaded." + re.sub(r"\W", "_", str(path.relative_to(path.parents[1])))
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
