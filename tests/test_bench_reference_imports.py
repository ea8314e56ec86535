"""The benchmark's plain references stand alone: no JAX, no JAX package and
no ``sift_tpu_torch`` (the program they judge), by their source and by what
importing them loads."""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
REFERENCE = ROOT / "benchmark" / "reference"
FORBIDDEN = ("jax", "jaxlib", "flax", "sift_tpu", "sift_tpu_torch")


def _imported(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")), ids=lambda p: p.name)
def test_reference_source_imports_no_program(path):
    for mod in _imported(path):
        assert mod.split(".")[0] not in FORBIDDEN, f"{path.name} imports {mod}"


def test_importing_the_sfm_reference_loads_no_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import benchmark.reference.sfm_plain, benchmark.reference.match_plain; "
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]", out.stdout
