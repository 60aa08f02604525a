"""Flight-rules static analysis framework of the port (DESIGN §13).

The port's own copy of the JAX package's `analysis/framework.py`, with the
same semantics: pure-stdlib (`ast`) lint infrastructure for the repo's own
invariants, which no generic linter knows about.

Three pieces:

* `Tree` — the file set under analysis. The anchor paths (engine, sim,
  allocator, config, serve CLI, docs) default to the port's files and are
  overridable, so rule tests can point at miniature fixture trees under
  `tests/fixtures/torch_analysis/` (or the JAX package's fixtures under
  `tests/fixtures/analysis/`, with `package` set to `src/repro`).
* rules — functions `rule(tree) -> [Finding]` registered by id via `@rule`
  in this package's own `RULES`, apart from the JAX package's registry.
  AST rules live in `rules_ast.py`, cross-file rules in `rules_repo.py`,
  the dispatch-level audit of the serving steps in `graph_audit.py`.
* the allowlist — `Allow` entries with an enforced justification: a
  finding is only suppressed by an entry carrying a real reason (>=
  MIN_REASON chars) whose (rule, path, scope) matches exactly `count`
  findings. Fewer matches = the entry is stale (the code it excused is
  gone); more = a new unreviewed site hides behind an old excuse. Both
  fail the run.
"""
from __future__ import annotations

import ast
import dataclasses
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: minimum justification length — long enough to force a real sentence
MIN_REASON = 20


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str            # rule id ("host-sync", "counter-parity", ...)
    path: str            # repo-relative posix path
    line: int            # 1-indexed anchor line
    message: str
    scope: str = ""      # enclosing qualified def; "" = module

    @property
    def anchor(self) -> str:
        return f"{self.path}:{self.line}"

    def __str__(self) -> str:
        return f"{self.anchor} [{self.rule}] {self.message}"


@dataclasses.dataclass(frozen=True)
class Allow:
    """One justified suppression. `scope` is the qualified enclosing
    function ("" = anywhere in the file); `count` is the exact number of
    findings the entry absorbs — a mismatch in either direction fails."""
    rule: str
    path: str
    scope: str
    count: int
    reason: str


@dataclasses.dataclass
class Tree:
    """The file set a run analyses, and the anchor files the cross-file
    rules read. `package` is the source package the rules hold: host-sync
    scans its `serving/`, `models/` and `kernels/`, and config-wiring
    counts a field as read only when code under it reads the field (a
    field only the JAX package reads is dead in the port). `scan` holds
    glob patterns relative to the root."""
    root: Path
    package: str = "src/repro_torch"
    engine: str = "src/repro_torch/serving/engine.py"
    sim: str = "src/repro_torch/serving/sim.py"
    kv_cache: str = "src/repro_torch/serving/kv_cache.py"
    config: str = "src/repro_torch/config/base.py"
    serve_cli: str = "src/repro_torch/launch/serve.py"
    readme: str = "README.md"
    docs_dir: str = "docs"
    scan: Tuple[str, ...] = ("src/repro_torch/**/*.py",
                             "tests/test_torch_*.py", "chip_smoke.py",
                             "examples/torch_*.py")
    # the rule-test corpus is deliberately full of violations
    exclude: Tuple[str, ...] = ("tests/fixtures/",)

    def __post_init__(self):
        self.root = Path(self.root)
        self._ast_cache: Dict[str, ast.Module] = {}

    def rel(self, p: Path) -> str:
        return p.relative_to(self.root).as_posix()

    def files(self) -> List[Path]:
        found = set()
        for pattern in self.scan:
            for p in self.root.glob(pattern):
                rp = self.rel(p)
                if p.is_file() and not any(
                        rp.startswith(e) or f"/{e}" in rp
                        for e in self.exclude):
                    found.add(p)
        return sorted(found)

    def read(self, relpath: str) -> Optional[str]:
        p = self.root / relpath
        return p.read_text() if p.exists() else None

    def parse(self, relpath: str) -> Optional[ast.Module]:
        if relpath not in self._ast_cache:
            text = self.read(relpath)
            self._ast_cache[relpath] = \
                ast.parse(text, filename=relpath) if text is not None else None
        return self._ast_cache[relpath]

    def doc_text(self) -> str:
        """README + every docs/*.md, lowercased with dashes normalized to
        underscores — the config-wiring rule's documentation corpus."""
        parts = []
        t = self.read(self.readme)
        if t:
            parts.append(t)
        docs = self.root / self.docs_dir
        if docs.exists():
            for p in sorted(docs.glob("*.md")):
                parts.append(p.read_text())
        return "\n".join(parts).lower().replace("-", "_")


# -- rule registry -----------------------------------------------------------

RULES: Dict[str, Callable[[Tree], List[Finding]]] = {}


def rule(rule_id: str):
    def deco(fn):
        RULES[rule_id] = fn
        fn.rule_id = rule_id
        return fn
    return deco


# -- AST helpers shared by rules ---------------------------------------------

def qualified_scopes(mod: ast.Module) -> Dict[ast.AST, str]:
    """Map every node to its qualified enclosing def ("Cls.meth")."""
    scopes: Dict[ast.AST, str] = {}

    def walk(node: ast.AST, scope: str):
        for child in ast.iter_child_nodes(node):
            s = scope
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                s = f"{scope}.{child.name}" if scope else child.name
            scopes[child] = s
            walk(child, s)
    walk(mod, "")
    return scopes


def dotted_name(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for Attribute/Name chains, '' otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def attr_chain(node: ast.AST) -> List[str]:
    """Attribute names along a value chain, subscripts transparent:
    `self.blocks.tables[rid].append` -> ['append', 'tables', 'blocks']."""
    out: List[str] = []
    while True:
        if isinstance(node, ast.Attribute):
            out.append(node.attr)
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        else:
            return out


# -- allowlist application ---------------------------------------------------

def apply_allowlist(findings: Sequence[Finding], allows: Sequence[Allow]
                    ) -> Tuple[List[Finding], List[Finding]]:
    """Returns (surviving findings, allowlist problems). An entry suppresses
    its matches only when justified AND matching exactly `count` findings."""
    problems: List[Finding] = []
    suppressed: set = set()
    for a in allows:
        where = f"{a.rule} @ {a.path}" + (f":{a.scope}" if a.scope else "")
        if len(a.reason.strip()) < MIN_REASON:
            problems.append(Finding(
                "allowlist", a.path, 0,
                f"unjustified allowlist entry ({where}): reason must be a "
                f"real sentence (>= {MIN_REASON} chars), got {a.reason!r}"))
            continue
        matched = [i for i, f in enumerate(findings)
                   if f.rule == a.rule and f.path == a.path
                   and (not a.scope or f.scope == a.scope)
                   and i not in suppressed]
        if len(matched) == a.count:
            suppressed.update(matched)
        elif not matched:
            problems.append(Finding(
                "allowlist", a.path, 0,
                f"stale allowlist entry ({where}): matches no finding — the "
                f"code it excused is gone; delete the entry"))
        else:
            problems.append(Finding(
                "allowlist", a.path, 0,
                f"allowlist count drift ({where}): entry declares "
                f"{a.count} finding(s) but {len(matched)} match — "
                f"re-review the site and update the count"))
    kept = [f for i, f in enumerate(findings) if i not in suppressed]
    return kept, problems


# -- runner ------------------------------------------------------------------

@dataclasses.dataclass
class Report:
    findings: List[Finding]
    problems: List[Finding]     # allowlist hygiene failures
    checked_files: int
    per_rule: Dict[str, int]

    @property
    def ok(self) -> bool:
        return not self.findings and not self.problems

    def to_json(self) -> str:
        return json.dumps({
            "ok": self.ok,
            "checked_files": self.checked_files,
            "per_rule": self.per_rule,
            "findings": [dataclasses.asdict(f) for f in self.findings],
            "allowlist_problems": [dataclasses.asdict(f)
                                   for f in self.problems],
        }, indent=2)


def run(tree: Tree, rule_ids: Optional[Sequence[str]] = None,
        allows: Sequence[Allow] = ()) -> Report:
    ids = list(rule_ids) if rule_ids is not None else sorted(RULES)
    raw: List[Finding] = []
    per_rule: Dict[str, int] = {}
    for rid in ids:
        found = RULES[rid](tree)
        per_rule[rid] = len(found)
        raw.extend(found)
    kept, problems = apply_allowlist(raw, allows)
    kept.sort(key=lambda f: (f.path, f.line, f.rule))
    return Report(kept, problems, len(tree.files()), per_rule)
