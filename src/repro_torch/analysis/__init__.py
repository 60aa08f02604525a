"""Flight-rules analysis of the port (DESIGN §13): repo-specific AST lint
rules with the port's own allowlist, plus a dispatch-level audit of the
engine's serving steps (`graph_audit.py`, which imports torch), run via
`python -m repro_torch.analysis`. The twin of `src/repro/analysis/`; its
rules register in their own `RULES`."""
from repro_torch.analysis.framework import (Allow, Finding, Report, Tree,
                                            RULES, apply_allowlist, rule, run)
# the rule modules register their rules on import
from repro_torch.analysis import rules_ast, rules_repo  # noqa: F401
from repro_torch.analysis.allowlist import ALLOWLIST

__all__ = ["Allow", "Finding", "Report", "Tree", "RULES", "ALLOWLIST",
           "apply_allowlist", "rule", "run"]
