"""Nothing the benchmark runs imports JAX or the JAX package `repro` (each
module's top-level name compared whole, so `repro_torch` passes), nor names
the folder of the JAX package's benchmark runners; the plain references
import nothing of the port."""
import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from perfbench.conftest import HERE, ROOT

BARRED = {"jax", "jaxlib", "flax", "repro"}
#: the JAX package's benchmark runners, a path no module may name
RUNNERS = "benchmarks" + "/"


def imported(path: Path):
    """Top-level names of every module `path` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & BARRED
    assert RUNNERS not in path.read_text()


@pytest.mark.parametrize("path", sorted(
    p for p in (HERE / "families").glob("*.py")
    if not p.stem.endswith("_port")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    assert imported(path) <= {"__future__", "math", "typing", "torch"}


def test_names_are_compared_whole():
    from perfbench.guard import barred_modules
    assert barred_modules(["repro_torch", "repro_torch.serving.engine",
                           "jaxtyping", "flaxen", "torch"]) == []
    assert barred_modules(["repro.core", "jax", "jaxlib.xla_client",
                           "flax.linen"]) == ["flax", "jax", "jaxlib",
                                              "repro"]


def test_a_run_loads_no_barred_module(tmp_path):
    """A whole tiny run in a fresh process, then the check the entry
    makes: what the port loads at run time shows here, not in a scan."""
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
        import torch
        torch.set_num_threads(1)
        from perfbench.conftest import TinyBench
        from perfbench.cell import run_cell
        from pathlib import Path
        t = TinyBench(Path({str(tmp_path)!r}))
        out = run_cell(t.bench(), "tiny-cell", 3, 0.6, False, "cpu")
        from perfbench.guard import barred_modules
        print(barred_modules(), out["correct"])
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[] True"
