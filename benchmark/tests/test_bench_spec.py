"""``BENCHMARK.json`` keeps the benchmark contract's rules on names, units,
keys and the files it names."""

import json
import re
from pathlib import Path

import pytest

from benchmark import spec

ROOT = spec.ROOT
B = spec.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def line_ok(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51


def test_command_and_paths():
    assert 1 <= len(B["command"]) <= 32 and all(line_ok(w) for w in B["command"])
    assert 1 <= len(B["paths"]) <= 16
    for p in B["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    for w in B["command"]:
        if "/" in w and (ROOT / w).exists():
            assert any(w.startswith(p + "/") for p in B["paths"])


def test_names_units_and_keys():
    names = []
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"]) and line_ok(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in B["paths"])
        names.append(c["name"])
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and line_ok(w["why"])
        names.append(w["name"])
    for m in B["end_to_end"] + B["per_layer"]:
        keys = {"name", "unit", "better", "source"}
        keys |= {"bound"} if m in B["end_to_end"] else {"layer", "moves"}
        assert set(m) - {"workloads"} == keys
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_configs_are_used_and_keep_their_widths():
    used = {w["config"] for w in B["workloads"]}
    files = [c["file"] for c in B["configs"]]
    assert len(files) == len(set(files))
    for c in B["configs"]:
        assert c["name"] in used
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        for k in c["reduced"]:
            assert cfg[k] != cfg["source_sizes"][k]
            assert not k.endswith(("_dim", "_rank")) and k != "n_samples"
        assert cfg["n_samples"] == cfg["source_sizes"]["n_samples"]
        assert "assumed" in cfg and "guarantees" in cfg


def test_metrics_bounds_and_sources():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in B["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line_ok(m["layer"]) and m["moves"] in e2e
        assert (spec.HERE / "metrics" / f"{m['name']}.py").exists()
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        for w in m.get("workloads", []):
            assert e2e[m["moves"]] in spec.Cell(B, w).end_to_end
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["better"] == "higher"
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("name", [w["name"] for w in B["workloads"]])
def test_every_cell_reports_enough(name):
    cell = spec.Cell(B, name)
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    assert (spec.HERE / "traffic" / f"{cell.workload['traffic']}.json").exists()
    for m in cell.per_layer:
        spec.reader(m["name"])
    for m in B["per_layer"]:
        if "workloads" not in m and m["moves"] in e2e:
            assert m in cell.per_layer
    if cell.mix["loop"] == "open":
        assert cell.mix["rate_per_s"] > 0


def test_four_chip_cells_are_few():
    four = sum(w["chips"] == 4 for w in B["workloads"])
    assert four <= max(1, len(B["workloads"]) // 4)


def test_harness_files_are_named_from_names():
    for p in Path(spec.HERE).rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
