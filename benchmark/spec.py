"""``BENCHMARK.json`` and the files it names: a cell's configuration (the
``file`` of its ``configs`` entry), its traffic mix
(``benchmark/traffic/<traffic>.json``) and its metrics: the end-to-end ones
the harness takes itself, and each per-layer one's reader
(``benchmark/metrics/<name>.py``, a function ``read(readings)`` that returns
a number, or None where it finds nothing to read)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell:
    def __init__(self, spec: dict, name: str, root: Path = ROOT,
                 traffic_dir: Path = HERE / "traffic"):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = cells[name]
        self.name = name
        conf = {c["name"]: c for c in spec["configs"]}[self.workload["config"]]
        self.config = json.loads((root / conf["file"]).read_text())
        self.mix = json.loads(
            (traffic_dir / f"{self.workload['traffic']}.json").read_text())
        self.chips = self.workload["chips"]
        self.end_to_end = [m for m in spec["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in spec["per_layer"] if self._has(m)]

    def _has(self, metric: dict) -> bool:
        """The cell reports ``metric``: it is listed for the cell, or, with
        no list, the cell reports the end-to-end metric it moves (for an
        end-to-end metric with no list: every cell)."""
        if "workloads" in metric:
            return self.name in metric["workloads"]
        if "moves" in metric:
            return any(m["name"] == metric["moves"] for m in self.end_to_end)
        return True


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def reader(name: str):
    """The ``read`` function of the per-layer metric ``name``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
