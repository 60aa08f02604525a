"""CLI: `python -m repro_torch.analysis [--report PATH] [--no-graphs]
[--root DIR] [--device cuda|cpu] [--variant reduced|full] [--arch ID]`.

Runs every registered AST rule of the port over the repo tree, applies the
port's justified allowlist, then (unless --no-graphs) the dispatch-level
audit of every registry arch's serving steps, and a one-rank mesh
engine's (only the --arch ones where given), on --device (the card by
default: without a GPU the audit raises unless --device cpu is given), and
exits non-zero on any surviving finding or allowlist hygiene problem.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--report", metavar="PATH", default=None,
                    help="write the JSON report here (CI artifact)")
    ap.add_argument("--no-graphs", action="store_true",
                    help="skip the audit of the serving steps (no torch "
                         "import)")
    ap.add_argument("--root", default=None,
                    help="repo root (default: derived from this package)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the step audit (default cuda)")
    ap.add_argument("--variant", default="reduced",
                    choices=("reduced", "full"),
                    help="config variant of the audited archs")
    ap.add_argument("--arch", action="append", default=None,
                    help="audit only this arch id (repeatable; default: "
                         "every registry arch)")
    args = ap.parse_args(argv)

    from repro_torch.analysis import ALLOWLIST, Tree, run
    device = None
    if not args.no_graphs:
        from repro_torch.models.model import resolve_device
        device = resolve_device(args.device)
    root = Path(args.root) if args.root else \
        Path(__file__).resolve().parents[3]
    report = run(Tree(root=root), allows=ALLOWLIST)

    if device is not None:
        from repro_torch.analysis.graph_audit import run_graph_audit
        audited = run_graph_audit(archs=args.arch, device=device,
                                  variant=args.variant)
        report.per_rule["graph-audit"] = len(audited)
        report.findings.extend(audited)

    for f in report.problems:
        print(f"PROBLEM {f}", file=sys.stderr)
    for f in report.findings:
        print(f, file=sys.stderr)
    if args.report:
        Path(args.report).write_text(report.to_json())
    n_rules = len(report.per_rule)
    if report.ok:
        print(f"analysis OK: {n_rules} rules over "
              f"{report.checked_files} files, 0 findings")
        return 0
    print(f"analysis FAILED: {len(report.findings)} finding(s), "
          f"{len(report.problems)} allowlist problem(s)", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
