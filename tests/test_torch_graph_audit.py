"""The port's dispatch-level audit of its serving steps (DESIGN §13,
`repro_torch.analysis.graph_audit`), the twin of tests/test_jaxpr_audit.py:
detector unit tests, seeded violations in the engine's steps, and every
registry arch's model functions and engine steps in both layouts on the
CPU.
"""
import pytest
import torch
from torch import nn

from repro_torch.analysis.graph_audit import (GraphAudit, OpTrace,
                                              audit_arch, audit_trace,
                                              run_graph_audit)
from repro_torch.config.registry import list_archs
from repro_torch.kernels import ops
from repro_torch.serving.engine import Engine

# one family per cache layout: dense GQA, pure SSM state, RG-LRU hybrid,
# MoE routing — the layouts with distinct prefill/decode/paged steps
SUBSET = ["granite-3-8b", "mamba2-2.7b", "recurrentgemma-9b",
          "qwen2-moe-a2.7b"]
OTHERS = [a for a in list_archs() if a not in SUBSET]


def trace(fn, *args):
    with torch.no_grad(), OpTrace() as tr:
        fn(*args)
    return audit_trace(tr, "t", "p.py"), tr


def test_detector_flags_float64():
    fs, _ = trace(lambda x: x * 2.0, torch.ones(2, dtype=torch.float64))
    assert [f.rule for f in fs] == ["graph-audit"]
    assert "float64 tensor in the serving step (first at aten.mul" \
        in fs[0].message


def test_detector_flags_float64_made_inside_the_step():
    fs, _ = trace(lambda x: (x.double() * 2).float(), torch.ones(2))
    assert any("float64" in f.message for f in fs)


X = torch.tensor([0.5, -1.0, 2.0, 0.0])

SYNCS = {
    "item": (lambda x: x[0].item(), "aten._local_scalar_dense"),
    "bool": (lambda x: bool((x > 0).any()), "aten._local_scalar_dense"),
    "mask_index": (lambda x: x[x > 0], "aten.index.Tensor"),
    "mask_assign": (lambda x: x.clone().__setitem__(x > 0, 0.0),
                    "aten.index_put_"),
    "nonzero": (lambda x: torch.nonzero(x), "aten.nonzero"),
    "masked_select": (lambda x: torch.masked_select(x, x > 0),
                      "aten.masked_select"),
    "unique": (lambda x: torch.unique(x), "aten._unique2"),
    "repeat_interleave": (
        lambda x: x.repeat_interleave(torch.tensor([1, 2, 1, 1])),
        "aten.repeat_interleave.Tensor"),
}


@pytest.mark.parametrize("case", sorted(SYNCS))
def test_detector_flags_syncs(case):
    fn, op = SYNCS[case]
    fs, _ = trace(fn, X)
    assert len(fs) == 1 and fs[0].rule == "graph-audit", fs
    assert fs[0].message.startswith(f"t: {op}")
    assert "hidden host sync" in fs[0].message


def test_detector_passes_fixed_shape_equivalents():
    def fn(x):
        keep = torch.where(x > 0, x, torch.zeros_like(x))
        idx = torch.tensor([0, 2])
        r = x.repeat_interleave(torch.tensor([1, 2, 1, 1]), output_size=5)
        return keep, x[idx], x.repeat_interleave(2), r, x.to(torch.float32)
    fs, tr = trace(fn, X)
    assert fs == [] and tr.ops > 5


def test_detector_reaches_nested_modules_and_loops():
    class Inner(nn.Module):
        def forward(self, x):
            for _ in range(3):
                x = x + x.sum().item()
            return x

    class Outer(nn.Module):
        def __init__(self):
            super().__init__()
            self.blocks = nn.ModuleList([nn.Linear(2, 2), Inner()])

        def forward(self, x):
            for b in self.blocks:
                x = b(x)
            return x.to(torch.float64)

    fs, _ = trace(Outer(), torch.ones(1, 2))
    msgs = [f.message for f in fs]
    assert any("float64" in m for m in msgs)
    assert any("aten._local_scalar_dense" in m and "(3x)" in m
               for m in msgs)


def test_clean_step_produces_no_findings():
    fs, tr = trace(lambda x: torch.tanh(x) + 1, torch.ones(2))
    assert fs == [] and tr.ops == 2


@pytest.mark.parametrize("arch", SUBSET)
def test_family_serving_steps_audit_clean(arch):
    audit = GraphAudit("cpu")
    audit.arch(arch)
    assert audit.findings == [], "\n".join(map(str, audit.findings))
    t = audit.totals()
    # four model functions; both layouts' warmup keys, each built once
    assert t["functions"] == 4 and t["steps"] == t["keys"] > 0
    assert t["builds"] == t["keys"] and t["captures"] == 0
    if arch == "granite-3-8b":
        # decode buckets 1, 2 and the lane chunks (contiguous: one per
        # lane row and the two-lane group; paged: 1 and 2 rows), a layout
        assert t["keys"] == (2 + 3) + (2 + 2)


@pytest.mark.parametrize("arch", OTHERS)
def test_other_archs_serving_steps_audit_clean(arch):
    fs = audit_arch(arch)
    assert fs == [], "\n".join(map(str, fs))


def test_run_graph_audit_subset_paths_anchor_configs():
    fs = run_graph_audit(archs=["granite-3-8b"])
    assert fs == []


# -- seeded violations in the engine's steps --------------------------------

def test_seeded_float64_in_a_step_caught(monkeypatch):
    norm = ops.add_rmsnorm

    def wide(x, y, w, **kw):
        return norm(x.double().to(x.dtype), y, w, **kw)

    monkeypatch.setattr(ops, "add_rmsnorm", wide)
    fs = audit_arch("granite-3-8b")
    assert fs and all("float64 tensor" in f.message for f in fs)
    assert {f.path for f in fs} == {"src/repro_torch/configs/granite_3_8b.py"}
    assert any("contiguous step ('decode', 2)" in f.message for f in fs)


def test_seeded_sync_in_a_step_caught(monkeypatch):
    norm = ops.rmsnorm

    def peek(x, w, **kw):
        if bool((x == 0).all()):
            x = x + 0
        return norm(x, w, **kw)

    monkeypatch.setattr(ops, "rmsnorm", peek)
    fs = audit_arch("granite-3-8b")
    assert fs and all("aten._local_scalar_dense" in f.message for f in fs)


def test_seeded_rebuild_per_call_caught(monkeypatch):
    def rebuild(self, key):
        st = self._build_step(key)
        self.graphs.steps[key] = st
        return st

    monkeypatch.setattr(Engine, "_step", rebuild)
    fs = audit_arch("granite-3-8b")
    assert len(fs) == 2, fs   # one a layout
    assert all("step builds for" in f.message for f in fs)
    assert "granite-3-8b contiguous: 9 step builds for 5 new shape keys" \
        in fs[0].message


def test_cli_graph_audit_on_the_cpu(tmp_path):
    import json

    from repro_torch.analysis.__main__ import main

    out = tmp_path / "report.json"
    assert main(["--device", "cpu", "--arch", "granite-3-8b",
                 "--report", str(out)]) == 0
    assert json.loads(out.read_text())["per_rule"]["graph-audit"] == 0
    if not torch.cuda.is_available():
        # the card is the default: no silent fall back to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--arch", "granite-3-8b"])


def test_card_config_keeps_a_head_dim_the_kernels_take():
    from repro_torch.analysis.graph_audit import card_config
    from repro_torch.config.registry import get_config
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    for arch in list_archs():
        cfg = get_config(arch, "reduced")
        cut = card_config(cfg)
        if cfg.num_heads:
            assert cut.resolved_head_dim in HEAD_DIMS
        assert (cut is cfg) == (arch != "starcoder2-7b")
    assert card_config(get_config("starcoder2-7b", "reduced")) \
        .resolved_head_dim == 32
