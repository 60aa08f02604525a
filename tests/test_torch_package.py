"""Guards of the port package: it imports neither JAX nor the JAX package,
its entry points run on the card unless asked for the CPU, its CLI has the
JAX CLI's flags plus --device, every arch id builds, and the tier and
mesh flags serve."""
import ast
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.config.base import AttentionKind, ServeConfig
from repro_torch.config.registry import get_config, list_archs
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
def test_tier_and_mesh_flags_serve_on_the_cpu(argv):
    """The memory tiers' flags serve every request on the paged pool;
    `--mesh 1,2` serves them tensor-parallel in two gloo rank processes,
    the CLI run as a user runs it, rank 0 printing the summary."""
    flags = argv + ["--device", "cpu", "--paged", "--requests", "3",
                    "--max-new", "3"]
    if argv[0] == "--mesh":
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve"] + flags,
            capture_output=True, text=True, timeout=180,
            env={**os.environ,
                 "PYTHONPATH": str(ROOT / "src")})
        assert proc.returncode == 0, proc.stderr[-3000:]
        summary = ast.literal_eval(proc.stdout.strip().splitlines()[-1])
        assert summary["finished"] == 3
        assert summary["model_shards"] == 2
        assert summary["pool_tokens"] == 2 * 4096
        return
    eng = port_serve.run(port_serve.build_parser().parse_args(flags))
    assert eng.summary()["finished"] == 3
    assert eng.prefix == (argv[0] == "--prefix-cache")
    assert eng.swap == (argv[0] == "--swap-space")


@pytest.mark.parametrize("arch", list_archs())
def test_every_arch_builds_in_the_port(arch):
    """Both variants configure; the full model builds without allocating;
    the reduced one runs a 3-token prefill (with extras where the family
    takes them) to finite logits on the CPU."""
    from repro_torch.models.backbone import cache_bytes, extras_key
    from repro_torch.models.model import default_enc_len

    full, small = get_config(arch, "full"), get_config(arch, "reduced")
    assert build_model(full, device="meta").cfg is full
    enc_len = default_enc_len(full)
    assert cache_bytes(full, 1, 16, enc_len=enc_len) > 0
    m = build_model(small, torch.float32, device="cpu")
    extras = {extras_key(small): torch.randn(1, 5, small.d_model)} \
        if enc_len else None
    lg, cache = m.prefill(m.init(0), torch.tensor([[1, 2, 3]]),
                          torch.arange(3, dtype=torch.int32)[None],
                          m.init_cache(1, 16, enc_len=5), extras=extras)
    assert lg.shape == (1, 3, small.vocab_size)
    assert bool(torch.isfinite(lg).all())
    assert ("cross_k" in cache) == bool(enc_len)


@pytest.mark.parametrize("arch,per_token,fixed", [
    # decoder self-attention K/V only; 12 cross layers x 1024 frames
    ("seamless-m4t-medium", 2 * 12 * 16 * 64 * 2,
     2 * 12 * 1024 * 16 * 64 * 2),
    # 80 self layers; 20 cross layers x 1601 patches
    ("llama-3.2-vision-90b", 2 * 80 * 8 * 128 * 2,
     2 * 20 * 1601 * 8 * 128 * 2)])
def test_cross_archs_memory_model(arch, per_token, fixed):
    """The memory model's K/V bytes a token and cross K/V bytes a request
    at full width (bf16), at the stub frontends' lengths."""
    from repro_torch.core.memory_model import MemoryModel
    from repro_torch.models.model import default_enc_len

    cfg = get_config(arch, "full")
    mem = MemoryModel(cfg, hbm_budget_bytes=0, eta_tokens=4096)
    assert mem.bytes_per_token == per_token
    assert mem.fixed_bytes_per_request(default_enc_len(cfg)) == fixed
    assert mem.fixed_bytes_per_request() == 0


@pytest.mark.parametrize("arch,per_token", [
    ("starcoder2-7b", 2 * 32 * 4 * 128 * 2),
    ("mistral-nemo-12b", 2 * 40 * 8 * 128 * 2),   # head_dim 128, not 160
    ("qwen1.5-32b", 2 * 64 * 40 * 128 * 2),
    ("qwen2-moe-a2.7b", 2 * 24 * 16 * 128 * 2)])
def test_attention_archs_memory_model_and_cli(arch, per_token, capsys):
    """The memory model's K/V bytes a token at full width (bf16), and the
    CLI serves the reduced config on the CPU."""
    from repro_torch.core.memory_model import MemoryModel

    mem = MemoryModel(get_config(arch, "full"), hbm_budget_bytes=0,
                      eta_tokens=4096)
    assert mem.bytes_per_token == per_token
    assert mem.fixed_bytes_per_request() == 0
    port_serve.main(["--device", "cpu", "--arch", arch, "--requests", "3",
                     "--max-new", "3", "--chunked", "--lanes", "2",
                     "--paged"])
    assert "'finished': 3" in capsys.readouterr().out


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_build_engine_takes_a_config_and_dtype(dtype):
    """`build_engine` serves a config the registry does not name (a
    sliding variant) in the weights' type asked for (fp32 for a reduced
    variant by default): its contiguous ring holds window + chunk - 1
    slots."""
    cfg = dataclasses.replace(get_config("mistral-nemo-12b", "reduced"),
                              attention=AttentionKind.SLIDING,
                              sliding_window=8)
    args = port_serve.build_parser().parse_args(
        ["--device", "cpu", "--arch", "mistral-nemo-12b"])
    eng = port_serve.build_engine(args, cfg=cfg, dtype=dtype)
    assert eng.model.cfg is cfg
    assert eng.params["embed"].dtype == (dtype or torch.float32)
    assert eng.cache["k"].shape[2] == 8 + 16 - 1
    hs = [eng.submit(list(range(1, 30)), max_new_tokens=3)]
    eng.run()
    assert len(hs[0].output_tokens) == 3


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
