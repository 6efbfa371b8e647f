"""What the harness and the reference import, by top-level module name:
no JAX and no ``bgt_tpu`` anywhere (``bgt_tpu_torch`` begins with
``bgt_tpu``, so names compare whole), and nothing of the program, nor
torch, in the reference, the client, the control and what they import."""

import ast
import sys
from pathlib import Path

import pytest

from benchmark import spec

HERE = spec.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "bgt_tpu"}
PROGRAM_FREE = ("reference.py", "client.py", "control.py", "cohort.py",
                "bcf_writer.py", "traffic.py", "judge.py", "yardstick.py")


def imports(path: Path) -> set:
    """Top-level names of every module ``path`` imports, at any depth of
    its code, and the files of this package it imports, followed."""
    seen, names, todo = set(), set(), [path]
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    mods = [f"benchmark.{node.module or ''}".rstrip(".")]
                    mods += [f"benchmark.{a.name}" for a in node.names]
                else:
                    mods = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            for m in mods:
                names.add(m.split(".")[0])
                parts = m.split(".")
                if parts[0] == "benchmark" and len(parts) > 1:
                    f = HERE.joinpath(*parts[1:]).with_suffix(".py")
                    if f.exists():
                        todo.append(f)
    return names


def harness_files():
    return sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", harness_files(), ids=lambda p: p.name)
def test_no_jax_and_no_bgt_tpu(path):
    assert not imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", PROGRAM_FREE)
def test_reference_side_imports_nothing_of_the_program(name):
    got = imports(HERE / name)
    assert "bgt_tpu_torch" not in got and "torch" not in got, got


def test_the_scan_sees_the_program_where_it_is():
    assert "bgt_tpu_torch" in imports(HERE / "run.py")
    assert "torch" in imports(HERE / "tracing.py")


def test_client_imports_only_the_standard_library_and_numpy():
    std = set(sys.stdlib_module_names) | {"numpy", "__future__"}
    assert imports(HERE / "client.py") <= std
