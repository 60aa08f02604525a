"""The port's example twins (examples/torch_*.py) run on the CPU when asked
and print their summaries; they import neither JAX nor the JAX package."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

#: example -> a line its summary prints
EXAMPLES = {
    "torch_quickstart.py": "summary: {'throughput_tok_s'",
    "torch_serve_dynamic.py": "== simulator (full 8B model",
    "torch_sla_capacity.py": "-- real engine, combined, cpu: attain=",
    "torch_train_small.py": "final loss",
}
#: example -> its arguments beside --device cpu: the trainer at a few
#: short steps, its checkpoint in the test's directory
ARGS = {"torch_train_small.py": ["--steps", "2", "--batch", "2", "--seq",
                                 "32", "--ckpt", "{tmp}/ckpt.npz"]}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path):
    path = ROOT / "examples" / name
    roots = {(a.name if isinstance(node, ast.Import) else node.module)
             .split(".")[0] for node in ast.walk(ast.parse(path.read_text()))
             if isinstance(node, (ast.Import, ast.ImportFrom))
             for a in getattr(node, "names", [])}
    assert not roots & {"jax", "jaxlib", "repro"}, roots
    out = subprocess.run(
        [sys.executable, str(path), "--device", "cpu"]
        + [a.format(tmp=tmp_path) for a in ARGS.get(name, [])],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert EXAMPLES[name] in out.stdout, out.stdout
    if name == "torch_quickstart.py":
        assert "'finished': 10" in out.stdout
    if name == "torch_train_small.py":
        assert (tmp_path / "ckpt.npz").is_file()
