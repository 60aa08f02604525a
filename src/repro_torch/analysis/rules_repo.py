"""Cross-file structural rules of the port (DESIGN §13), the JAX
package's `rules_repo.py` on the port's anchors.

counter-parity
    Every scalar key the port's `Engine.summary()` returns must have a
    same-named field (or property) of the port's `SimResult`, and vice
    versa. The port's engine/sim differential harness
    (`tests/test_torch_differential.py`, DESIGN §7) compares the twins
    counter by counter — a counter that exists on one side only silently
    escapes the parity net. List-valued SimResult fields (traces, decision
    logs) are structurally exempt: they are not scalar counters.

config-wiring
    Every field of the port's `ServeConfig` must be (a) read somewhere in
    the port's package (`Tree.package`): a field only the JAX package
    reads is dead in the port; (b) wired through the port's serving CLI
    (`launch/serve.py` passes it as a `ServeConfig(...)` keyword) so
    operators can actually turn it; and (c) named in README/docs.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.framework import Finding, Tree, rule


def _find_class(mod: ast.Module, name: str) -> Optional[ast.ClassDef]:
    for node in ast.walk(mod):
        if isinstance(node, ast.ClassDef) and node.name == name:
            return node
    return None


# -- counter-parity ----------------------------------------------------------

def _summary_keys(cls: ast.ClassDef) -> Dict[str, int]:
    """String keys of the dict literal(s) `summary()` returns -> lineno."""
    out: Dict[str, int] = {}
    for node in cls.body:
        if isinstance(node, ast.FunctionDef) and node.name == "summary":
            for ret in ast.walk(node):
                if isinstance(ret, ast.Return) \
                        and isinstance(ret.value, ast.Dict):
                    for k in ret.value.keys:
                        if isinstance(k, ast.Constant) \
                                and isinstance(k.value, str):
                            out[k.value] = k.lineno
    return out


def _scalar_fields(cls: ast.ClassDef) -> Dict[str, int]:
    """SimResult scalar counters: annotated fields (lists exempt) plus
    @property accessors -> lineno."""
    out: Dict[str, int] = {}
    for node in cls.body:
        if isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            ann = ast.unparse(node.annotation)
            if re.search(r"\b(List|Dict|list|dict)\b", ann):
                continue
            out[node.target.id] = node.lineno
        elif isinstance(node, ast.FunctionDef):
            decos = {ast.unparse(d) for d in node.decorator_list}
            if "property" in decos:
                out[node.name] = node.lineno
    return out


@rule("counter-parity")
def check_counter_parity(tree: Tree) -> List[Finding]:
    out: List[Finding] = []
    eng_mod, sim_mod = tree.parse(tree.engine), tree.parse(tree.sim)
    if eng_mod is None or sim_mod is None:
        return out
    eng_cls = _find_class(eng_mod, "Engine")
    sim_cls = _find_class(sim_mod, "SimResult")
    if eng_cls is None or sim_cls is None:
        return out
    keys = _summary_keys(eng_cls)
    fields = _scalar_fields(sim_cls)
    for k in sorted(set(keys) - set(fields)):
        out.append(Finding(
            "counter-parity", tree.engine, keys[k],
            f"Engine.summary() key '{k}' has no SimResult twin — the "
            f"differential harness cannot compare it (add the field to "
            f"SimResult or justify an engine-only counter)",
            scope="Engine.summary"))
    for k in sorted(set(fields) - set(keys)):
        out.append(Finding(
            "counter-parity", tree.sim, fields[k],
            f"SimResult scalar '{k}' has no Engine.summary() key — the "
            f"differential harness cannot compare it (surface it in "
            f"summary() or justify a sim-only counter)",
            scope="SimResult"))
    return out


# -- config-wiring -----------------------------------------------------------

def _serveconfig_fields(tree: Tree) -> Dict[str, int]:
    mod = tree.parse(tree.config)
    if mod is None:
        return {}
    cls = _find_class(mod, "ServeConfig")
    if cls is None:
        return {}
    return {node.target.id: node.lineno for node in cls.body
            if isinstance(node, ast.AnnAssign)
            and isinstance(node.target, ast.Name)}


def _attribute_reads(tree: Tree, skip: Tuple[str, ...]) -> Set[str]:
    """Every attribute name read anywhere under the package (minus
    `skip`)."""
    reads: Set[str] = set()
    for p in tree.files():
        rp = tree.rel(p)
        if not rp.startswith(f"{tree.package}/") or rp in skip:
            continue
        mod = tree.parse(rp)
        if mod is None:
            continue
        for node in ast.walk(mod):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.ctx, ast.Load):
                reads.add(node.attr)
    return reads


def _cli_wired_fields(tree: Tree) -> Set[str]:
    """Keywords of every ServeConfig(...) call in launch/serve.py."""
    mod = tree.parse(tree.serve_cli)
    wired: Set[str] = set()
    if mod is None:
        return wired
    for node in ast.walk(mod):
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else \
                fn.attr if isinstance(fn, ast.Attribute) else ""
            if name == "ServeConfig":
                wired.update(kw.arg for kw in node.keywords if kw.arg)
    return wired


@rule("config-wiring")
def check_config_wiring(tree: Tree) -> List[Finding]:
    fields = _serveconfig_fields(tree)
    if not fields:
        return []
    reads = _attribute_reads(tree, skip=(tree.config,))
    wired = _cli_wired_fields(tree)
    docs = tree.doc_text()
    out: List[Finding] = []
    for f, line in sorted(fields.items()):
        if f not in reads:
            out.append(Finding(
                "config-wiring", tree.config, line,
                f"dead ServeConfig field '{f}': nothing under "
                f"{tree.package}/ reads it — wire it into the engine/sim "
                f"or delete it"))
            continue  # dead fields need no CLI flag or doc row
        if f not in wired:
            out.append(Finding(
                "config-wiring", tree.config, line,
                f"ServeConfig field '{f}' is not wired through the serving "
                f"CLI: launch/serve.py never passes it to ServeConfig(...) "
                f"— operators cannot turn this knob"))
        if f not in docs:
            out.append(Finding(
                "config-wiring", tree.config, line,
                f"ServeConfig field '{f}' is undocumented: name it in the "
                f"README or docs/ (dashes and case are normalized)"))
    return out
