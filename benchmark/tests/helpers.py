"""Small cells for the CPU tests: the tiny configuration and mixes under
``data/``, as cells of a benchmark held in memory.  A closed-loop cell
reports ``gt_per_s`` and the ``.scan`` metrics, whose entries
(``data/scan_metrics.json``) wait in the tests for the first such cell of
``BENCHMARK.json``."""

import json
from pathlib import Path

from benchmark import spec

DATA = Path(__file__).resolve().parent / "data"


def tiny_cell(mix: str, config: str = "tiny") -> spec.Cell:
    full = spec.load()
    scan = json.loads((DATA / "scan_metrics.json").read_text())
    full = {k: full[k] + scan.get(k, []) for k in ("end_to_end", "per_layer")}
    name = f"{config}.{mix}"
    is_open = json.loads((DATA / f"{mix}.json").read_text())["loop"] == "open"
    fam = "open" if is_open else "scan"
    e2e = [dict(m, workloads=[name]) for m in full["end_to_end"]
           if "workloads" not in m or (m["name"] != "gt_per_s") == is_open]
    per = [dict(m, workloads=[name]) for m in full["per_layer"]
           if m["name"].endswith("." + fam)]
    s = {"configs": [{"name": config, "file": str(DATA / f"{config}.json")}],
         "workloads": [{"name": name, "config": config, "traffic": mix,
                        "chips": 1}],
         "end_to_end": e2e, "per_layer": per}
    return spec.Cell(s, name, root=Path("/"), traffic_dir=DATA)
