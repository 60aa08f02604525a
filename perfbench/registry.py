"""Finds what `BENCHMARK.json` names: configurations, traffic mixes, cells
and metrics, each in a file of its own under the benchmark's folder."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: what a metric's reader module declares, and the BENCHMARK.json key each
#: must agree with
DECLARED = {"LAYER": "layer", "UNIT": "unit", "MOVES": "moves",
            "BETTER": "better", "SOURCE": "source"}


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """`BENCHMARK.json` at `root` and the files under `here`."""

    def __init__(self, root: Path = ROOT, here: Path = HERE):
        self.root, self.here = Path(root), Path(here)
        self.spec = _json(self.root / "BENCHMARK.json")
        self._modules: Dict[str, ModuleType] = {}

    def _module(self, path: Path) -> ModuleType:
        key = str(path)
        if key not in self._modules:
            self._modules[key] = load_module(
                path, "perfbench_" + path.stem.replace(".", "_")
                .replace("-", "_"))
        return self._modules[key]

    # -- cells, configurations, mixes --------------------------------------
    def cell(self, name: str) -> Dict:
        """The cell's BENCHMARK.json entry merged with its file."""
        entry = next((w for w in self.spec["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        return {**_json(self.here / "workloads" / f"{name}.json"), **entry}

    def config(self, name: str) -> Dict:
        c = next((c for c in self.spec["configs"] if c["name"] == name),
                 None)
        if c is None:
            raise KeyError(f"no config {name!r} in BENCHMARK.json")
        return {**_json(self.root / c["file"]), "name": name,
                "source": c["source"]}

    def traffic(self, name: str) -> Dict:
        return _json(self.here / "traffic" / f"{name}.json")

    def family(self, config: Dict) -> Tuple[ModuleType, ModuleType]:
        """The configuration's plain reference and its port adapter."""
        f = config["family"]
        return (self._module(self.here / "families" / f"{f}.py"),
                self._module(self.here / "families" / f"{f}_port.py"))

    # -- metrics -----------------------------------------------------------
    def metrics(self, cell: str, trace: bool) -> List[Dict]:
        """The metrics a run of `cell` prints: the end-to-end ones without
        a trace, the per-layer ones with it; those with a `workloads` key
        only in the cells it lists."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.spec[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: Dict):
        """`read(run) -> float | None` of a metric: `metrics/<name>.py`, or
        `metrics/<name>.json` naming another reader and its arguments. The
        module's declarations must agree with BENCHMARK.json."""
        name = metric["name"]
        py = self.here / "metrics" / f"{name}.py"
        args: Dict = {}
        if py.exists():
            mod = self._module(py)
            declared = {key: getattr(mod, attr)
                        for attr, key in DECLARED.items()
                        if hasattr(mod, attr)}
        else:
            spec = _json(self.here / "metrics" / f"{name}.json")
            mod = self._module(self.here / "metrics" / f"{spec['reader']}.py")
            args = spec.get("args", {})
            declared = {k: spec[k] for k in DECLARED.values() if k in spec}
        for key, have in declared.items():
            if have != metric[key]:
                raise ValueError(f"metric {name}: its reader declares "
                                 f"{key} {have!r}, BENCHMARK.json "
                                 f"{metric[key]!r}")
        return lambda run: mod.read(run, **args)

    def read_metrics(self, run, cell: str, trace: bool
                     ) -> Dict[str, Dict[str, float]]:
        """{name: {"value", "unit"}} of every metric the run prints whose
        reader found something to read."""
        out = {}
        for m in self.metrics(cell, trace):
            v: Optional[float] = self.reader(m)(run)
            if v is not None:
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
        return out
