"""AST lint rules over the port's serving stack (DESIGN §13).

host-sync
    A call that makes the host wait for the device. Inside the port's
    `serving/`, `models/` and `kernels/` every such site either sits on
    the scheduling loop (the engine) or inside a step that is captured as
    a CUDA graph (the model and the kernels' wrappers), where a sync
    either fails the capture or, eagerly, stalls the dispatch-ahead
    pipeline (DESIGN §14). Flagged: `.item()`, `.tolist()`, `.cpu()`,
    `.numpy()`, `.to(...)` to the CPU, any `.synchronize()` (device,
    stream, event), `nonzero` (a data-dependent output shape), and
    `np.asarray` / `np.array` on a non-literal operand. Each must be an
    allowlisted, justified sync point. The JAX rule sees only jax's sync
    calls, `.item()` and numpy coercions; the dispatch-level audit
    (`graph_audit.py`) sees what no source line shows (`bool(t)`, a
    boolean-mask index), and this rule sees what never reaches the
    dispatcher (`.tolist()`, a CPU-to-CPU `.cpu()`).

allocator-encapsulation
    BlockManager's refcounts, free lists, block tables, prefix index and
    swap ledgers may only be mutated inside the port's `kv_cache.py` (the
    JAX rule's protected and mutator sets, unchanged).
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.framework import (Finding, Tree, attr_chain,
                                            dotted_name, qualified_scopes,
                                            rule)

# -- host-sync ---------------------------------------------------------------

#: the port's sub-packages whose code runs on the serving loop or inside a
#: captured step
SYNC_SCOPE = ("serving", "models", "kernels")

#: no-argument methods that copy a device tensor to the host and wait
_READBACK = {
    "item": "copies a device scalar to the host",
    "tolist": "copies a tensor into host Python values",
    "cpu": "copies a tensor to host memory",
}

#: numpy coercions that pull a device tensor to host when fed one
_NP_COERCE = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}

#: argument node types that are host-side literals, not device values
_HOST_LITERAL = (ast.List, ast.Tuple, ast.ListComp, ast.Constant,
                 ast.GeneratorExp)


def _is_cpu(node: ast.AST) -> bool:
    """"cpu" or torch.device("cpu")."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return isinstance(node, ast.Call) \
        and dotted_name(node.func) in ("torch.device", "device") \
        and bool(node.args) and _is_cpu(node.args[0])


def _sync_message(node: ast.Call) -> str:
    name = dotted_name(node.func)
    fn = node.func
    attr = fn.attr if isinstance(fn, ast.Attribute) else ""
    if attr in _READBACK and not node.args and not node.keywords:
        return (f".{attr}() {_READBACK[attr]} and waits for the stream "
                f"(an implicit sync) — batch the readback behind an event "
                f"or allowlist it")
    if attr == "numpy":
        return (".numpy() reads host memory: a device tensor needs a "
                "blocking copy first (an implicit sync) — keep host data "
                "on the host or allowlist it")
    if attr == "to" and (any(_is_cpu(a) for a in node.args) or any(
            kw.arg == "device" and _is_cpu(kw.value)
            for kw in node.keywords)):
        return (".to() the CPU is a blocking device-to-host copy (an "
                "implicit sync) — copy into pinned memory without blocking "
                "or allowlist it")
    if attr == "synchronize":
        return (f"{name or '.synchronize'}() blocks the host until the "
                f"device, stream or event finishes — the serving loop's "
                f"one fence is the retirement's; allowlist with a "
                f"justification or move off the critical path")
    if attr == "nonzero":
        return (f"{name or '.nonzero'}() has a data-dependent output shape: "
                f"the host waits for the device to size it (and a capture "
                f"fails) — use a fixed-shape mask or index")
    if name in _NP_COERCE and node.args \
            and not isinstance(node.args[0], _HOST_LITERAL):
        return (f"{name}() on a non-literal operand copies a device tensor "
                f"to host (an implicit sync) — use host data or allowlist "
                f"with a justification")
    return ""


@rule("host-sync")
def check_host_sync(tree: Tree) -> List[Finding]:
    out: List[Finding] = []
    prefixes = tuple(f"{tree.package}/{d}/" for d in SYNC_SCOPE)
    for p in tree.files():
        rp = tree.rel(p)
        if not rp.startswith(prefixes):
            continue
        mod = tree.parse(rp)
        if mod is None:
            continue
        scopes = qualified_scopes(mod)
        for node in ast.walk(mod):
            if isinstance(node, ast.Call):
                msg = _sync_message(node)
                if msg:
                    out.append(Finding("host-sync", rp, node.lineno, msg,
                                       scope=scopes.get(node, "")))
    return out


# -- allocator-encapsulation -------------------------------------------------

#: BlockManager state only kv_cache.py may mutate (DESIGN §9/§10/§11)
_PROTECTED = {"tables", "swapped_tables", "ref", "_free", "_swap_free",
              "_cached", "_index", "_hash_of", "_commit", "_released",
              "_deferred", "_epoch_open", "_shadow_snap"}

#: container methods that mutate their receiver
_MUTATORS = {"append", "extend", "insert", "pop", "remove", "clear",
             "setdefault", "update", "popitem"}


def _protected_target(node: ast.AST) -> str:
    """The protected attribute a store/del target reaches, or ''."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and node.attr in _PROTECTED:
        return node.attr
    return ""


@rule("allocator-encapsulation")
def check_allocator_encapsulation(tree: Tree) -> List[Finding]:
    out: List[Finding] = []
    for p in tree.files():
        rp = tree.rel(p)
        if rp == tree.kv_cache:
            continue
        mod = tree.parse(rp)
        if mod is None:
            continue
        scopes = qualified_scopes(mod)

        def flag(node, attr, how):
            out.append(Finding(
                "allocator-encapsulation", rp, node.lineno,
                f"mutation of BlockManager.{attr} ({how}) outside "
                f"kv_cache.py — allocator state changes only through "
                f"BlockManager methods (the allocator drift-family guard)",
                scope=scopes.get(node, "")))

        for node in ast.walk(mod):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    attr = _protected_target(t)
                    if attr:
                        flag(node, attr, "assignment")
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    attr = _protected_target(t)
                    if attr:
                        flag(node, attr, "del")
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _MUTATORS:
                chain = attr_chain(node.func)
                hit = next((a for a in chain[1:] if a in _PROTECTED), "")
                if hit:
                    flag(node, hit, f".{node.func.attr}()")
    return out
