"""Guards of the port package: it imports neither JAX nor the JAX package,
its entry points run on the card unless asked for the CPU, its CLI has the
JAX CLI's flags plus --device, and features it has not ported raise."""
import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.config.base import ServeConfig
from repro_torch.config.registry import get_config
from repro_torch.launch import serve as port_serve
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_runs_with_jax_unimportable():
    """Every port module imports, and a CPU forward runs, in a process
    where `import jax` fails."""
    code = f"""
import importlib, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
for name in {_modules()!r}:
    importlib.import_module(name)
import torch
from repro_torch.config.registry import get_config
from repro_torch.models.model import build_model
m = build_model(get_config("granite-3-8b", "reduced"), torch.float32, "cpu")
p = m.init(0)
tok = torch.tensor([[1, 2, 3]])
pos = torch.arange(3, dtype=torch.int32)[None]
lg, _ = m.prefill(p, tok, pos, m.init_cache(1, 16))
assert lg.shape == (1, 3, 512) and bool(torch.isfinite(lg).all())
assert not any(k == "repro" or k.startswith(("repro.", "jax"))
               for k, v in sys.modules.items() if v is not None)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    cfg = get_config("granite-3-8b", "reduced")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    m = build_model(cfg, torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(m, m.init(0), ServeConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_serve.run(port_serve.build_parser().parse_args(["--requests", "1"]))


def _flags(parser):
    return {s for a in parser._actions for s in a.option_strings
            if s.startswith("--") and s != "--help"}


def test_cli_flags_are_the_jax_cli_flags_plus_device():
    jax_cli = (ROOT / "src" / "repro" / "launch" / "serve.py").read_text()
    jax_flags = set(re.findall(r"add_argument\(\s*\"(--[\w-]+)\"", jax_cli))
    assert _flags(port_serve.build_parser()) == jax_flags | {"--device"}


@pytest.mark.parametrize("argv", [["--prefix-cache"], ["--swap-space", "4"],
                                  ["--mesh", "1,2"]])
def test_unported_features_raise(argv):
    args = port_serve.build_parser().parse_args(argv + ["--device", "cpu"])
    with pytest.raises(NotImplementedError):
        port_serve.run(args)


def test_unported_archs_raise():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        get_config("qwen2-moe-a2.7b", "reduced")


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-9b"])
def test_stateful_families_build_and_serve_on_cpu(arch, capsys):
    """Both variants configure, the memory model builds (an SSM request
    costs its fixed state, no bytes per token), and the CLI serves."""
    from repro_torch.core.memory_model import MemoryModel

    full = get_config(arch, "full")
    mem = MemoryModel(full, hbm_budget_bytes=0, eta_tokens=4096)
    if arch == "mamba2-2.7b":
        assert mem.bytes_per_token == 0
        # 64 layers x (3 x 5376 bf16 conv taps + 80 x 64 x 128 fp32 state)
        assert mem.fixed_bytes_per_request() == 64 * (3 * 5376 * 2
                                                      + 80 * 64 * 128 * 4)
    else:
        assert mem.bytes_per_token == 2 * 12 * 1 * 256 * 2
    port_serve.main(["--device", "cpu", "--arch", arch, "--requests", "3",
                     "--max-new", "3", "--chunked", "--lanes", "2",
                     "--paged"])
    assert "'finished': 3" in capsys.readouterr().out


def test_cli_serves_on_cpu(capsys):
    port_serve.main(["--device", "cpu", "--requests", "3", "--max-new", "3",
                     "--chunked", "--lanes", "2", "--paged"])
    assert "'finished': 3" in capsys.readouterr().out
