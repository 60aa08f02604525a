"""The port's workload module against the JAX package's (DESIGN §15): with
the same seed every generator gives the same arrivals, a `repro-trace`
file written by either package is byte for byte the other's and reads back
the same in both, malformed files fail with the same `path:line` errors,
and the feeds put the same requests into the simulators.
"""
import dataclasses
import json
import warnings

import pytest

from repro.config.base import ServeConfig as JServeConfig
from repro.config.registry import get_config as jax_config
from repro.serving import workload as jw
from repro.serving.cost_model import CostModel as JCostModel, \
    PROFILES as JPROFILES
from repro.serving.sim import LengthDist as JLengthDist, \
    ServingSimulator as JSim
from repro_torch.config.base import ServeConfig
from repro_torch.config.registry import get_config
from repro_torch.serving import workload as pw
from repro_torch.serving.cost_model import CostModel, PROFILES
from repro_torch.serving.sim import LengthDist, ServingSimulator

LENGTHS = dict(mean_in=40.0, mean_out=24.0, cv_in=0.4, cv_out=0.6)


def _events(evs):
    return [dataclasses.asdict(e) for e in evs]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("gen,kw", [
    ("poisson", dict(rate=3.0, n=60)),
    ("bursty", dict(base_rate=1.0, burst_rate=12.0, period_s=10.0,
                    duty=0.2, n=80)),
    ("diurnal", dict(mean_rate=4.0, amplitude=0.8, period_s=30.0, n=80)),
], ids=["poisson", "bursty", "diurnal"])
def test_length_generators_match_jax(gen, kw, seed):
    ours = getattr(pw, gen)(lengths=LengthDist(**LENGTHS), seed=seed, **kw)
    ref = getattr(jw, gen)(lengths=JLengthDist(**LENGTHS), seed=seed, **kw)
    assert ours == ref
    assert len(ours) == kw["n"]


@pytest.mark.parametrize("fixed", [False, True])
def test_length_dist_matches_jax(fixed):
    import random

    a, b = random.Random(3), random.Random(3)
    ours = LengthDist(**LENGTHS, fixed=fixed)
    ref = JLengthDist(**LENGTHS, fixed=fixed)
    assert [ours.sample(a) for _ in range(200)] \
        == [ref.sample(b) for _ in range(200)]


@pytest.mark.parametrize("seed", [0, 3])
def test_shared_prefix_matches_jax(seed):
    kw = dict(rate=2.0, n=40, vocab_size=300, n_system_prompts=3,
              system_len=24, p_followup=0.6, max_turns=3, seed=seed)
    ours, ref = pw.shared_prefix(**kw), jw.shared_prefix(**kw)
    assert ours == ref and len(ours) == 40


@pytest.mark.parametrize("seed", [0, 5])
def test_reference_trace_matches_jax(seed):
    ours = pw.reference_trace(50, seed=seed, vocab_size=700)
    ref = jw.reference_trace(50, seed=seed, vocab_size=700)
    assert _events(ours) == _events(ref)
    assert any(e.parent_id is not None for e in ours)


def _streams(mod=jw):
    """Arrival tuples, token tuples and trace events (the last of `mod`'s
    own TraceEvent type)."""
    lengths = jw.poisson(2.0, 12, JLengthDist(**LENGTHS), seed=1)
    tokens = jw.shared_prefix(1.5, 10, vocab_size=200, seed=2)
    trace = mod.reference_trace(16, seed=3, vocab_size=200)
    return {"lengths": lengths, "tokens": tokens, "trace": trace}


@pytest.mark.parametrize("kind", ["lengths", "tokens", "trace"])
def test_trace_files_are_byte_identical_and_cross_read(kind, tmp_path):
    stream = _streams(pw)[kind]
    mine, theirs = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    pw.save_trace(str(mine), stream)
    jw.save_trace(str(theirs), _streams(jw)[kind])
    assert mine.read_bytes() == theirs.read_bytes()
    # each package reads the other's file to the same events and tuples
    assert _events(pw.load_trace_events(str(theirs))) \
        == _events(jw.load_trace_events(str(mine)))
    assert pw.load_trace(str(theirs)) == jw.load_trace(str(mine))
    # and a port round trip keeps every record
    back = pw.load_trace_events(str(mine))
    assert len(back) == len(stream)
    if kind == "trace":
        assert _events(back) == _events(stream)


def test_legacy_headerless_file_reads_alike(tmp_path):
    path = tmp_path / "legacy.jsonl"
    path.write_text("".join(json.dumps({"t": 0.5 * i, "l_in": 4 + i,
                                        "l_out": 2 + i}) + "\n"
                            for i in range(5)))
    assert _events(pw.load_trace_events(str(path))) \
        == _events(jw.load_trace_events(str(path)))


BAD = {
    "not-json": ['{"schema": "repro-trace", "version": 1}', "{oops"],
    "not-object": ["[1, 2]"],
    "schema": ['{"schema": "other", "version": 1}'],
    "version": ['{"schema": "repro-trace", "version": 2}'],
    "kind": ['{"schema": "repro-trace", "version": 1, "kind": "pixels"}'],
    "t": ['{"t": -1, "l_in": 3, "l_out": 2}'],
    "t-bool": ['{"t": true, "l_in": 3, "l_out": 2}'],
    "l_out": ['{"t": 0, "l_in": 3, "l_out": 0}'],
    "l_in": ['{"t": 0, "l_in": 2.5, "l_out": 1}'],
    "tokens": ['{"schema": "repro-trace", "version": 1, "kind": "tokens"}',
               '{"t": 0, "tokens": [], "l_out": 1}'],
    "token-neg": ['{"schema": "repro-trace", "version": 1, "kind": "tokens"}',
                  '{"t": 0, "tokens": [1, -2], "l_out": 1}'],
    "id": ['{"t": 0, "l_in": 3, "l_out": 2, "id": "a"}'],
    "dup-id": ['{"t": 0, "l_in": 3, "l_out": 2, "id": 4}',
               '{"t": 1, "l_in": 3, "l_out": 2, "id": 4}'],
    "parent": ['{"t": 0, "l_in": 3, "l_out": 2, "id": 0}',
               '{"t": 1, "l_in": 3, "l_out": 2, "id": 1, "parent_id": 7}'],
    "parent-type": ['{"t": 0, "l_in": 3, "l_out": 2, "parent_id": 0.5}'],
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_malformed_traces_fail_alike(case, tmp_path):
    path = tmp_path / f"{case}.jsonl"
    path.write_text("\n".join(BAD[case]) + "\n")
    with pytest.raises(pw.TraceFormatError) as ours:
        pw.load_trace_events(str(path))
    with pytest.raises(jw.TraceFormatError) as ref:
        jw.load_trace_events(str(path))
    assert str(ours.value) == str(ref.value)
    assert str(ours.value).startswith(f"{path}:")
    assert issubclass(pw.TraceFormatError, ValueError)


def test_out_of_order_timestamps_sort_with_a_warning(tmp_path):
    path = tmp_path / "shuffled.jsonl"
    path.write_text("".join(json.dumps({"id": i, "t": t, "l_in": 3,
                                        "l_out": 2}) + "\n"
                            for i, t in enumerate((2.0, 0.5, 1.0))))
    with pytest.warns(UserWarning, match="out of order") as rec:
        ours = pw.load_trace_events(str(path))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jw.load_trace_events(str(path))
    assert _events(ours) == _events(ref)
    assert [e.t for e in ours] == [0.5, 1.0, 2.0]
    assert str(rec[0].message) == f"{path}: arrival timestamps out of " \
                                  f"order; sorting"


@pytest.mark.parametrize("seed", [0, 4])
def test_trace_prompts_match_jax(seed):
    def events(mod):
        return mod.reference_trace(12, seed=seed, vocab_size=2000) \
            + [mod.TraceEvent(t=9.0, l_out=3, l_in=7, id=99)]

    assert pw.trace_prompts(events(pw), 512, seed=seed) \
        == jw.trace_prompts(events(jw), 512, seed=seed)


def _sims():
    cfg, jcfg = get_config("granite-3-8b", "reduced"), \
        jax_config("granite-3-8b", "reduced")
    kw = dict(policy="memory", b_max=8, kv_pool_tokens=2048,
              chunked_prefill=True, n_prefill_lanes=2, paged_kv=True)
    ours = ServingSimulator(cfg, ServeConfig(**kw),
                            CostModel(cfg, PROFILES["a100x8"]),
                            LengthDist(**LENGTHS), prefill_chunk=16)
    ref = JSim(jcfg, JServeConfig(**kw),
               JCostModel(jcfg, JPROFILES["a100x8"]),
               JLengthDist(**LENGTHS), prefill_chunk=16)
    return ours, ref


def _requests(sim):
    return [(r.rid, r.arrival_time, r.prompt_len, r.prompt_tokens,
             r.true_output_len, r.max_new_tokens) for r in sim._all]


def test_feeds_put_the_same_requests_into_the_sims():
    """feed, feed_tokens and feed_trace, called one after another on one
    sim (rids offset past the population), then a run: the same requests
    and the same result in both packages."""
    ours, ref = _sims()
    for mod, sim in ((pw, ours), (jw, ref)):
        s = _streams(mod)
        sim.add_requests(3, arrival_rate=2.0)
        mod.feed(sim, s["lengths"])
        mod.feed_tokens(sim, s["tokens"])
        new = mod.feed_trace(sim, s["trace"])
        assert [r.rid for r in new] == list(range(25, 41))
    assert _requests(ours) == _requests(ref)
    assert dataclasses.asdict(ours.run()) == dataclasses.asdict(ref.run())
