"""Fixtures of the benchmark's tests: a throwaway benchmark tree holding one
tiny dense configuration, a mix and a cell, beside copies of the real
families and metrics, that runs on the CPU in seconds."""
import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

TINY = {"family": "dense", "num_hidden_layers": 2, "hidden_size": 64,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "intermediate_size": 128, "vocab_size": 256, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-5, "tie_word_embeddings": False,
        "torch_dtype": "float32"}
TINY_MIX = {"arrivals": {"process": "poisson"},
            "prompt_tokens": {"dist": "lognormal", "mean": 24, "cv": 0.6,
                              "min": 4, "max": 64},
            "output_tokens": {"dist": "lognormal", "mean": 8, "cv": 0.6,
                              "min": 2, "max": 16}}
TINY_CELL = {"serve": ["--paged", "--policy", "combined", "--sla-ms", "50",
                       "--chunked", "--lanes", "2", "--overlap-depth", "2",
                       "--b-max", "8", "--max-context", "256",
                       "--pool-tokens", "2048"],
             "rate_per_s": 20.0, "warm_seconds": 1.0, "trace_seconds": 0.5,
             "check": {"sample_requests": 4, "gap_limit": 1e-3}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where "
        "torch.cuda.is_available() is false")


class TinyBench:
    """A benchmark tree under `root`: `BENCHMARK.json` with the real
    metrics and the tiny configuration, mix and cell; `add_*` write more
    files, as a later change would."""

    def __init__(self, root: Path):
        self.root = root
        self.here = root / "perfbench"
        for d in ("families", "metrics"):
            shutil.copytree(HERE / d, self.here / d,
                            ignore=shutil.ignore_patterns("__pycache__"))
        for d in ("configs", "traffic", "workloads"):
            (self.here / d).mkdir(parents=True)
        spec = json.loads((ROOT / "BENCHMARK.json").read_text())
        spec["configs"], spec["workloads"] = [], []
        for m in spec["per_layer"]:
            m.pop("workloads", None)
        self.spec = spec
        self.add_config("tiny", TINY)
        self.add_traffic("mix", TINY_MIX)
        self.add_cell("tiny-cell", "tiny", "mix", TINY_CELL)

    def _save(self):
        (self.root / "BENCHMARK.json").write_text(json.dumps(self.spec))

    def add_config(self, name, body):
        (self.here / "configs" / f"{name}.json").write_text(json.dumps(body))
        self.spec["configs"].append({
            "name": name, "source": "https://example.org/" + name,
            "file": f"perfbench/configs/{name}.json", "reduced": [],
            "why": "a test"})
        self._save()

    def add_traffic(self, name, body):
        (self.here / "traffic" / f"{name}.json").write_text(json.dumps(body))

    def add_cell(self, name, config, mix, body):
        (self.here / "workloads" / f"{name}.json").write_text(
            json.dumps(body))
        self.spec["workloads"].append({"name": name, "config": config,
                                       "traffic": mix, "chips": 1,
                                       "why": "a test"})
        self._save()

    def add_metric(self, entry, kind="per_layer", source=None,
                   suffix=".py"):
        if source is not None:
            (self.here / "metrics" / f"{entry['name']}{suffix}").write_text(
                source)
        self.spec[kind].append(entry)
        self._save()

    def bench(self):
        from perfbench.registry import Bench
        return Bench(self.root, self.here)


@pytest.fixture
def tiny(tmp_path):
    """The tiny tree, its runs on one CPU thread (the suite runs in several
    processes at once: more threads only contend)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield TinyBench(tmp_path)
    torch.set_num_threads(n)


@pytest.fixture
def tiny_cell():
    return copy.deepcopy(TINY_CELL)


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, at run time)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
