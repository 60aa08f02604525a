"""A cell, a configuration, a traffic mix and a metric added as new files
are found and run by the harness without an edit to any existing file."""
import copy
import json

import pytest

from perfbench.cell import run_cell
from perfbench.conftest import TINY, TINY_MIX

NEW_METRIC = '''"""Window requests that got a first token, in %."""
LAYER = "load generator"
UNIT = "%"
MOVES = "ttft_p90_s"
BETTER = "higher"
SOURCE = "host_clock"


def read(run, floor=0.0):
    reqs = run.window_reqs
    if not reqs:
        return None
    return max(floor, 100.0 * sum(1 for r in reqs if r.token_times)
               / len(reqs))
'''


def entry(name, **kw):
    e = {"name": name, "unit": "%", "better": "higher",
         "source": "host_clock", "layer": "load generator",
         "moves": "ttft_p90_s"}
    e.update(kw)
    return e


def test_new_files_are_found_and_run(tiny, tiny_cell):
    # a configuration, a mix and a cell, each a new file
    cfg = dict(TINY, hidden_size=96, num_attention_heads=6, head_dim=16,
               tie_word_embeddings=True)
    tiny.add_config("tiny-tied", cfg)
    mix = copy.deepcopy(TINY_MIX)
    mix["arrivals"] = {"process": "square_wave", "base": 0.5, "burst": 2.0,
                       "period_s": 1.0, "duty": 0.5}
    tiny.add_traffic("bursts", mix)
    # a short traced slice: the CPU's profiler slows every step it sees
    tiny.add_cell("tiny-bursts", "tiny-tied", "bursts",
                  dict(tiny_cell, trace_seconds=0.05))
    # a metric as a reader of its own, and one as a JSON file naming it
    tiny.add_metric(entry("answered_share",
                          workloads=["tiny-bursts"]), source=NEW_METRIC)
    tiny.add_metric(entry("answered_share_floored"),
                    source=json.dumps({"reader": "answered_share",
                                       "args": {"floor": 1.0}}),
                    suffix=".json")
    bench = tiny.bench()
    out = run_cell(bench, "tiny-bursts", 5, 2.0, True, "cpu")
    assert out["correct"], out["check"]
    m = out["metrics"]
    assert 0.0 < m["answered_share"]["value"] <= 100.0
    assert m["answered_share"]["unit"] == "%"
    assert m["answered_share_floored"]["value"] >= 1.0
    assert "decode_batch_mean" in m
    # the metric restricted to the new cell is not read in the old one
    out = run_cell(bench, "tiny-cell", 5, 1.0, True, "cpu")
    assert "answered_share" not in out["metrics"]
    assert "answered_share_floored" in out["metrics"]


def test_a_reader_that_disagrees_with_the_benchmark_is_refused(tiny):
    tiny.add_metric(entry("answered_share", unit="count"),
                    source=NEW_METRIC)
    bench = tiny.bench()
    with pytest.raises(ValueError, match="unit"):
        bench.reader(bench.spec["per_layer"][-1])


def test_the_real_benchmark_names_a_file_for_everything():
    from perfbench.registry import Bench
    b = Bench()
    for w in b.spec["workloads"]:
        cell = b.cell(w["name"])
        cfg = b.config(cell["config"])
        b.family(cfg)
        b.traffic(cell["traffic"])
        assert cell["check"]["gap_limit"] > 0
    for kind in ("end_to_end", "per_layer"):
        for m in b.spec[kind]:
            b.reader(m)
