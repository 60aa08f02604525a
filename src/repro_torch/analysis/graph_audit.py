"""Dispatch-level audit of the port's serving steps (DESIGN §13), the twin
of the JAX package's jaxpr audit (`src/repro/analysis/jaxpr_audit.py`).

PyTorch has no `make_jaxpr`: a step is audited by running it once, eagerly,
under a `TorchDispatchMode` (`OpTrace`) that sees every aten op the step
dispatches, with its input and output tensors. Three audits, rule id
`graph-audit`:

* **dtype**: no float64 or complex128 tensor as an input or output of any
  op in the step (the step's static inputs, the cache and the weights are
  inputs of the ops that read them). A stray float64 silently doubles K/V
  bytes a token and halves every MemoryModel budget the scheduler trusts.
* **sync** (the twin of the callback audit): no op that makes the host
  wait: `_local_scalar_dense` (`.item()`, `bool(t)`), the ops whose output
  shape depends on the data (`nonzero`, `is_nonzero`, `masked_select`,
  `unique*`), a boolean-mask `index` or `index_put`, `repeat_interleave`
  by a tensor of counts without `output_size`, and any op that moves a
  CUDA tensor to the CPU. `.tolist()` and a CPU-to-CPU `.cpu()` never
  reach the dispatcher: the host-sync lint (`rules_ast.py`) covers those,
  and the two layers hold the steps together.
* **recapture**: each decode bucket's step is run twice through
  `Engine._step`. The engine must build exactly one step per distinct
  shape key (`len(engine.graphs.steps)`), and on the card capture each
  once (`graphs.captures`): a step rebuilt per call turns every
  scheduling interval into a capture.

Two kinds of functions are audited per registry arch: the model-level
functions the JAX audit traces (`Model.decode_step`, `prefill` with the
family's extras, `decode_step_paged`) plus `prefill_paged`; and the
engine's own `Step.fn` for every key `Engine.warmup` builds, in both cache
layouts, which are exactly the functions the engine captures as CUDA
graphs.

The port's kernels are ctypes launches the dispatcher does not see; their
outputs and scratch are allocated by torch ops, which it does see, so a
kernel wrapper's dtype is audited, its launch is not (on the CPU a
wrapper runs its plain version, every op of which is seen).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.framework import Finding
from repro_torch.config.base import ServeConfig
from repro_torch.config.registry import _ARCH_MODULES, get_config, list_archs
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models.backbone import extras_key
from repro_torch.models.model import build_model, default_enc_len
from repro_torch.serving.engine import Engine

RULE = "graph-audit"

#: dtypes banned anywhere in a serving step
BAD_DTYPES = (torch.float64, torch.complex128)

#: ops whose output shape depends on the data: the host reads it
DATA_SHAPED = ("nonzero", "is_nonzero", "masked_select")

#: ops that index by a tensor list (`indices`)
INDEXING = ("index", "index_put", "index_put_", "_index_put_impl_")

#: the audited shapes: decode buckets, context, prefill chunk, cross keys
#: a request (VLM, enc-dec) and the paged block size; the audit checks
#: dtypes, syncs and builds, which these sizes do not change
BUCKETS = (1, 2)
MAX_CONTEXT = 32
CHUNK = 8
ENC_LEN = 16
BLOCK_SIZE = 16


def _bind(func, args, kwargs) -> Dict[str, object]:
    """The op's arguments by schema name."""
    bound = dict(zip((a.name for a in func._schema.arguments), args))
    bound.update(kwargs)
    return bound


def sync_reason(func, args, kwargs, out) -> str:
    """Why the op makes the host wait for the device, or ''."""
    name = func.overloadpacket.__name__
    if name == "_local_scalar_dense":
        return "reads a device scalar on the host (.item(), bool(), int())"
    if name in DATA_SHAPED or name.startswith(("unique", "_unique")):
        return ("its output shape depends on the data: the host waits for "
                "the device to size it")
    if name in INDEXING or name == "repeat_interleave":
        bound = _bind(func, args, kwargs)
        if any(isinstance(i, torch.Tensor)
               and i.dtype in (torch.bool, torch.uint8)
               for i in bound.get("indices") or ()):
            return ("a boolean-mask index: the host reads how many "
                    "elements it selects")
        if isinstance(bound.get("repeats"), torch.Tensor) \
                and bound.get("output_size") is None:
            return ("repeat_interleave by a tensor of counts without "
                    "output_size: the host reads their sum")
    ins = [t for t in tree_leaves((args, kwargs))
           if isinstance(t, torch.Tensor)]
    if any(t.is_cuda for t in ins) and any(
            isinstance(t, torch.Tensor) and t.device.type == "cpu"
            for t in tree_leaves(out)):
        return "copies a CUDA tensor to host memory"
    return ""


class OpTrace(TorchDispatchMode):
    """Records, while active, every aten op dispatched: the count, the
    first op that touched each banned dtype, and each op that syncs."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.bad_dtypes: Dict[str, str] = {}
        self.syncs: Dict[str, int] = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        for t in tree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor) and t.dtype in BAD_DTYPES:
                self.bad_dtypes.setdefault(
                    str(t.dtype).removeprefix("torch."), str(func))
        why = sync_reason(func, args, kwargs, out)
        if why:
            self.syncs[f"{func} {why}"] += 1
        return out


def audit_trace(tr: OpTrace, step: str, path: str) -> List[Finding]:
    """The dtype and sync findings of one traced step."""
    out = [Finding(RULE, path, 1,
                   f"{step}: {dt} tensor in the serving step (first at "
                   f"{op}) — double-width math silently breaks every "
                   f"MemoryModel byte budget")
           for dt, op in sorted(tr.bad_dtypes.items())]
    out += [Finding(RULE, path, 1,
                    f"{step}: {what} ({n}x) — a hidden host sync inside a "
                    f"step the engine captures as a CUDA graph")
            for what, n in sorted(tr.syncs.items())]
    return out


def card_config(cfg):
    """`cfg`, or on the card a copy whose attention head_dim the attention
    kernels take (`HEAD_DIMS`, the largest not above the config's): a
    reduced config sized for the CPU may have another (starcoder2-7b's
    reduced 144 / 4 heads = 36)."""
    hd = cfg.resolved_head_dim
    if not cfg.num_heads or hd in HEAD_DIMS:
        return cfg
    return dataclasses.replace(
        cfg, head_dim=max((h for h in HEAD_DIMS if h <= hd),
                          default=HEAD_DIMS[0]))


def config_path(arch: str) -> str:
    return f"src/repro_torch/configs/{_ARCH_MODULES[arch]}.py"


class GraphAudit:
    """Audits steps on one device and keeps the totals a report prints:
    findings, functions (model-level) and engine steps traced, aten ops
    seen, distinct step keys, step builds and graph captures, and the
    kernel launches the traced steps made (on the card)."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.findings: List[Finding] = []
        self.functions = 0
        self.steps = 0
        self.ops = 0
        self.keys = 0
        self.builds = 0
        self.captures = 0
        self.launches: Dict[str, int] = collections.Counter()
        #: arch -> the config fields `card_config` changed
        self.cuts: Dict[str, Dict[str, int]] = {}

    def trace(self, step: str, path: str, fn, *args) -> None:
        """Run `fn(*args)` once under `OpTrace` and audit what it ran."""
        before = dict(ops.LAUNCHES)
        with torch.no_grad(), OpTrace() as tr:
            fn(*args)
        for k, n in ops.LAUNCHES.items():
            if n != before[k]:
                self.launches[k] += n - before[k]
        self.ops += tr.ops
        self.findings.extend(audit_trace(tr, step, path))

    def model(self, model, params, name: str, path: str) -> None:
        """The model-level functions: a decode step, a prefill chunk (with
        the family's extras), and both again through the paged pools."""
        dev, b, T = model.device, max(BUCKETS), CHUNK
        enc_len = ENC_LEN if default_enc_len(model.cfg) else 0
        extras = {extras_key(model.cfg): torch.zeros(
            (1, enc_len, model.cfg.d_model), dtype=model.dtype,
            device=dev)} if enc_len else None
        toks = torch.zeros((b,), dtype=torch.int64, device=dev)
        lens = torch.full((b,), -1, dtype=torch.int32, device=dev)
        tt = torch.zeros((1, T), dtype=torch.int64, device=dev)
        pos = torch.arange(T, dtype=torch.int32, device=dev)[None]
        calls = [
            ("decode_step", model.decode_step,
             (params, toks, lens, model.init_cache(b, MAX_CONTEXT,
                                                   enc_len=enc_len))),
            ("prefill", model.prefill,
             (params, tt, pos, model.init_cache(
                 1, MAX_CONTEXT, enc_len=enc_len, prefill_chunk=T),
              extras))]
        mb = -(-MAX_CONTEXT // BLOCK_SIZE)
        pool = model.init_paged_cache(b * mb, BLOCK_SIZE, n_slots=b,
                                      enc_len=enc_len)
        rows = torch.arange(b, dtype=torch.int64, device=dev)
        tables = torch.full((b, mb), -1, dtype=torch.int32, device=dev)
        calls += [
            ("decode_step_paged", model.decode_step_paged,
             (params, toks, lens, tables, pool, rows)),
            ("prefill_paged",
             lambda *a: model.prefill_paged(*a, extras=extras),
             (params, tt, pos, tables[:1], pool, rows[:1]))]
        for fname, fn, args in calls:
            self.trace(f"{name} {fname}", path, fn, *args)
            self.functions += 1

    def engine(self, eng, name: str, path: str) -> None:
        """The engine's steps: `warmup` builds (on the card, captures)
        every decode bucket and full-chunk lane shape; every step the
        engine holds is traced; then each decode bucket's step runs twice
        through `Engine._step`, which must build no key twice."""
        steps = eng.graphs.steps
        had, builds = len(steps), 0
        build = eng._build_step

        def counted(key):
            nonlocal builds
            builds += 1
            return build(key)

        eng._build_step = counted
        try:
            eng.warmup()
            for key in sorted(steps, key=str):
                self.trace(f"{name} step {key}", path, steps[key].fn,
                           steps[key].inputs)
                self.steps += 1
            for b in eng.buckets:
                for _ in range(2):
                    eng._step(("decode", b)).run()
        finally:
            del eng._build_step
        new = len(steps) - had
        self.keys += len(steps)
        self.builds += builds
        if builds != new:
            self.findings.append(Finding(
                RULE, path, 1,
                f"{name}: {builds} step builds for {new} new shape "
                f"keys — expected exactly one build per key (a step rebuilt "
                f"per call turns every scheduling interval into a "
                f"capture)"))
        if eng.graphs.enabled:
            self.captures += eng.graphs.captures
            if eng.graphs.captures != len(steps):
                self.findings.append(Finding(
                    RULE, path, 1,
                    f"{name}: {eng.graphs.captures} graph captures for "
                    f"{len(steps)} distinct step keys — expected exactly "
                    f"one capture per key"))

    def arch(self, arch: str, variant: str = "reduced") -> None:
        """The model-level functions and both layouts' engine steps of one
        registry arch: in bf16 on the card, at a head_dim its attention
        kernels take (`card_config`), and in fp32 on the CPU."""
        path = config_path(arch)
        dtype = torch.bfloat16 if self.device.type == "cuda" \
            else torch.float32
        cfg = get_config(arch, variant)
        if self.device.type == "cuda":
            cut = card_config(cfg)
            if cut is not cfg:
                self.cuts[arch] = dict(head_dim=cut.head_dim)
            cfg = cut
        model = build_model(cfg, dtype=dtype, device=self.device)
        params = model.init(0)
        self.model(model, params, arch, path)
        for paged in (False, True):
            serve = ServeConfig(
                policy="memory", b_max=max(BUCKETS), batch_buckets=BUCKETS,
                chunked_prefill=True, n_prefill_lanes=2, paged_kv=paged,
                block_size=BLOCK_SIZE,
                kv_pool_tokens=max(BUCKETS) * MAX_CONTEXT)
            eng = Engine(model, params, serve, max_context=MAX_CONTEXT,
                         buckets=BUCKETS, prefill_chunk=CHUNK,
                         enc_len=ENC_LEN if default_enc_len(cfg) else 0,
                         device=self.device)
            self.engine(eng, f"{arch} {'paged' if paged else 'contiguous'}",
                        path)
            del eng

    def totals(self) -> Dict[str, object]:
        return dict(findings=len(self.findings), functions=self.functions,
                    steps=self.steps, ops=self.ops, keys=self.keys,
                    builds=self.builds, captures=self.captures,
                    launches=dict(sorted(self.launches.items())),
                    cuts=self.cuts)


def audit_arch(arch: str, device="cpu",
               variant: str = "reduced") -> List[Finding]:
    """The whole audit of one registry arch (reduced by default)."""
    audit = GraphAudit(device)
    audit.arch(arch, variant)
    return audit.findings


def run_graph_audit(archs: Optional[Sequence[str]] = None, device="cpu",
                    variant: str = "reduced",
                    audit: Optional[GraphAudit] = None) -> List[Finding]:
    """Audit `archs` (default: every registry arch) into `audit` (a new
    one by default); returns its findings."""
    audit = audit or GraphAudit(device)
    for arch in (archs if archs is not None else list_archs()):
        audit.arch(arch, variant=variant)
    return audit.findings
