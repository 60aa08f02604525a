"""Preemption in the port's engine (DESIGN §11), on the CPU (reduced
granite-3-8b, fp32, paged), with the JAX engine's weights
(`params.from_jax_params`).

* tests/test_preemption.py on the port: newest-victim order in both
  modes, TTFT re-attributed after a recompute and kept after a swap-in,
  outputs bitwise-identical across no pressure, recompute and forced swap
  (chunked and not), shared prefix blocks never swapped.
* The port against the JAX engine with swap forced, at depth 0 and 2: the
  same block tables after every step(), then the same tokens and counters.
* The host pool's round trip: the rows restored at the new block ids are
  the swapped-out rows byte for byte.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import ServeConfig as JServeConfig
from repro.config.registry import get_config as jax_config
from repro.models.model import build_model as jax_build
from repro.serving.engine import Engine as JEngine
from repro_torch.config.base import ServeConfig
from repro_torch.config.registry import get_config
from repro_torch.models.model import build_model
from repro_torch.params import from_jax_params
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import RequestState

LENS = [40, 44, 38, 46]
#: the summary counters the port must share with the JAX engine
COUNTERS = ("finished", "admitted", "preemptions", "oom_events", "rejected",
            "decode_steps", "prefill_tokens", "mean_batch", "swap_outs",
            "swap_ins", "swap_out_bytes", "swap_in_bytes", "swapped_peak",
            "copy_bytes", "prefix_hit_tokens", "prefix_query_tokens",
            "cached_blocks", "cache_evictions")
_W = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced engines run many tiny ops: one intra-op thread serves
    them faster than a pool, and keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def weights():
    """(JAX config, JAX model, JAX params, port model, port params): the
    same reduced granite-3-8b weights on both sides."""
    if not _W:
        jcfg = jax_config("granite-3-8b", "reduced")
        jm = jax_build(jcfg, dtype=jnp.float32)
        jp = jm.init(jax.random.PRNGKey(0))
        m = build_model(get_config("granite-3-8b", "reduced"),
                        dtype=torch.float32, device="cpu")
        _W.update(w=(jcfg, jm, jp, m, from_jax_params(jax.device_get(jp))))
    return _W["w"]


def serve_kw(*, pool=160, swap=0, preempt="auto", b_max=4, chunked=True,
             prefix=False, depth=0):
    return dict(policy="static", b_max=b_max, max_new_tokens=12,
                kv_pool_tokens=pool, block_size=16, chunked_prefill=chunked,
                chunk_budget_tokens=16, n_prefill_lanes=2, paged_kv=True,
                prefix_cache=prefix, swap_space_blocks=swap, preempt=preempt,
                overlap_depth=depth)


ENGINE_KW = dict(max_context=96, buckets=(1, 2, 4), prefill_chunk=8)


def make_engine(**kw):
    _, _, _, m, p = weights()
    return Engine(m, p, ServeConfig(**serve_kw(**kw)), device="cpu",
                  **ENGINE_KW)


def submit_burst(eng, lens, max_new=12, seed=0, prompts=None):
    vocab = weights()[0].vocab_size
    rng = np.random.RandomState(seed)
    hs = []
    for i, pl in enumerate(lens):
        toks = prompts[i] if prompts else \
            list(map(int, rng.randint(0, vocab, size=pl)))
        hs.append(eng.submit(list(toks), max_new_tokens=max_new,
                             arrival_time=0.0))
    return hs


def step_until_preemption(eng, max_steps=2000):
    """Drive the engine until the first preemption; returns the active
    rids before that step."""
    for _ in range(max_steps):
        before = [r.rid for r in eng.active]
        pre = eng.preemptions
        if not eng.step():
            break
        if eng.preemptions > pre:
            return before
    return None


@pytest.mark.parametrize("swap,preempt", [(0, "auto"), (32, "swap")])
def test_newest_victim_ordering(swap, preempt):
    """The first victims are the newest active requests, in recompute and
    in swap mode."""
    eng = make_engine(swap=swap, preempt=preempt)
    hs = submit_burst(eng, LENS)
    before = step_until_preemption(eng)
    assert before is not None, "workload did not trigger preemption"
    gone = [rid for rid in before if rid not in {r.rid for r in eng.active}
            and not any(h.rid == rid and h.state == RequestState.FINISHED
                        for h in hs)]
    assert gone == before[-len(gone):][::-1] or gone == before[-len(gone):]
    if swap:
        assert eng.swap_outs > 0
        assert all(r.rid in gone for r in eng.swapped)
    eng.run(max_steps=5000)
    assert eng.total_finished == len(LENS)


def test_ttft_reattribution_after_recompute():
    """A recompute victim's prefill start resets, so its TTFT is
    re-attributed to the second life."""
    eng = make_engine(swap=0)
    hs = submit_burst(eng, LENS)
    assert step_until_preemption(eng) is not None
    victims = [h for h in hs if h.state == RequestState.WAITING
               and h.rid in {r.rid for r in eng.waiting}]
    assert victims
    for v in victims:
        assert v.prefill_start_time == -1.0
        assert v.output_tokens == []
    t_preempt = eng._now()
    eng.run(max_steps=5000)
    assert eng.total_finished == len(LENS)
    for v in victims:
        assert v.prefill_start_time >= t_preempt
        assert v.first_token_time >= t_preempt


def test_ttft_preserved_after_swap_in():
    """A swapped-in request resumes mid-decode: its TTFT stands, its
    tokens survive the round trip and the latency is accounted."""
    eng = make_engine(swap=32, preempt="swap")
    submit_burst(eng, LENS)
    assert step_until_preemption(eng) is not None
    assert eng.swapped, "expected a swapped victim"
    v = eng.swapped[0]
    ftt, pst = v.first_token_time, v.prefill_start_time
    n_out = len(v.output_tokens)
    assert ftt >= 0 and n_out > 0
    eng.run(max_steps=5000)
    assert eng.total_finished == len(LENS)
    assert v.first_token_time == ftt
    assert v.prefill_start_time == pst
    assert v.n_swaps >= 1 and v.swapped_s > 0
    assert len(v.output_tokens) > n_out
    s = eng.summary()
    assert s["swap_latency_s_mean"] > 0
    assert s["swap_out_bytes"] > 0 and s["swap_in_bytes"] > 0
    assert s["swapped_peak"] >= 1


@pytest.mark.parametrize("chunked", [False, True])
def test_outputs_bitwise_identical_across_modes(chunked):
    """No pressure, recompute and forced swap give byte-identical outputs
    (greedy: swap restores the exact K/V bytes, recompute regenerates
    them), and the host pool and the allocator end full."""
    rng = np.random.RandomState(3)
    vocab = weights()[0].vocab_size
    prompts = [list(map(int, rng.randint(0, vocab, size=pl)))
               for pl in LENS]

    def run(pool, swap, preempt):
        eng = make_engine(pool=pool, swap=swap, preempt=preempt,
                          chunked=chunked)
        hs = submit_burst(eng, LENS, prompts=prompts)
        eng.run(max_steps=5000)
        assert eng.total_finished == len(LENS)
        assert eng.blocks.free_blocks == eng.blocks.num_blocks
        assert eng.blocks.host_free_blocks == swap
        return [h.output_tokens for h in hs], eng

    out_no, _ = run(4096, 0, "auto")
    out_rc, eng_rc = run(160, 0, "auto")
    out_sw, eng_sw = run(160, 32, "swap")
    assert eng_rc.preemptions > 0 and eng_rc.swap_outs == 0
    assert eng_sw.swap_outs > 0 and eng_sw.swap_ins == eng_sw.swap_outs
    assert out_no == out_rc == out_sw


def test_shared_prefix_blocks_never_swapped():
    """Under prefix sharing a victim whose table holds a shared block
    recomputes: no swapped request keeps a device table."""
    rng = np.random.RandomState(5)
    vocab = weights()[0].vocab_size
    system = list(map(int, rng.randint(0, vocab, size=48)))
    prompts = [system + list(map(int, rng.randint(0, vocab, size=4 + i)))
               for i in range(4)]
    eng = make_engine(swap=32, preempt="swap", prefix=True)
    hs = [eng.submit(p, max_new_tokens=24, arrival_time=0.0)
          for p in prompts]
    for _ in range(5000):
        if not eng.step():
            break
        for r in eng.swapped:
            assert r.rid not in eng.blocks.block_tables
    assert eng.total_finished == 4
    assert eng.preemptions > 0
    for h in hs:
        assert len(h.output_tokens) == 24


# ---------------------------------------------------------------------------
# the port against the JAX engine


def _tables(eng, port):
    if port:
        return ({r: eng.blocks.table(r) for r in eng.blocks.block_tables},
                {r: list(t) for r, t in
                 eng.blocks.swapped_block_tables.items()})
    return ({r: list(t) for r, t in eng.blocks.tables.items()},
            {r: list(t) for r, t in eng.blocks.swapped_tables.items()})


def lockstep(kw, prompts, max_new=12, w=None):
    """The port and the JAX engine on the same ServeConfig and prompts,
    stepped together: the same block tables and swap ledgers after every
    step(), then (returned) both engines and their requests. `w`: other
    weights than `weights()`, in its layout."""
    jcfg, jm, jp, m, p = w or weights()
    ref = JEngine(jm, jp, JServeConfig(**kw), **ENGINE_KW)
    ours = Engine(m, p, ServeConfig(**kw), device="cpu", **ENGINE_KW)
    hs = [(ours.submit(t, max_new_tokens=max_new, arrival_time=0.0),
           ref.submit(t, max_new_tokens=max_new, arrival_time=0.0))
          for t in prompts]
    n = 0
    while True:
        a, b = ours.step(), ref.step()
        assert a == b, n
        assert _tables(ours, True) == _tables(ref, False), n
        assert len(ours._inflight) == len(ref._inflight), n
        assert [r.rid for r in ours.swapped] == [r.rid for r in ref.swapped]
        if not a:
            break
        n += 1
    assert [h.output_tokens for h, _ in hs] \
        == [h.output_tokens for _, h in hs]
    s, js = ours.summary(), ref.summary()
    assert {k: s[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    return ours, ref


@pytest.mark.parametrize("depth", [0, 2])
def test_port_matches_jax_engine_swap_forced(depth):
    """Forced swap under a tight pool, chunked on two lanes: tables,
    ledgers, tokens and the swap counters are the JAX engine's."""
    vocab = weights()[0].vocab_size
    rng = np.random.RandomState(1)
    prompts = [list(map(int, rng.randint(0, vocab, size=n)))
               for n in (40, 44, 38, 46, 9)]
    ours, _ = lockstep(serve_kw(swap=32, preempt="swap", depth=depth),
                       prompts)
    assert ours.swap_outs > 0 and ours.swap_ins == ours.swap_outs


def test_host_pool_round_trip_is_byte_for_byte():
    """The rows a swap-in writes at the new block ids are the K, V and pos
    rows the swap-out took from the old ones, bit for bit."""
    eng = make_engine(swap=32, preempt="swap")
    submit_burst(eng, LENS)
    taken, restored = {}, []
    swap_out, swap_in = eng._swap_out, eng._swap_in_next

    def rows(ids):
        ids = torch.tensor(ids)
        return {k: eng.cache[k].index_select(0 if k == "pos" else 1,
                                             ids).clone()
                for k in ("k", "v", "pos")}

    def out_spy(slot, r):
        taken[r.rid] = rows(eng.blocks.table(r.rid))
        swap_out(slot, r)

    def in_spy():
        rid = eng.swapped[0].rid
        ok = swap_in()
        if ok:
            got = rows(eng.blocks.table(rid))
            for k, v in got.items():
                assert torch.equal(v, taken[rid][k]), (rid, k)
            restored.append((rid, got))
        return ok

    eng._swap_out, eng._swap_in_next = out_spy, in_spy
    eng.run(max_steps=5000)
    assert eng.total_finished == len(LENS) and restored
    # the positions are the request's own: block j holds 16j .. 16j + 15
    rid, got = restored[0]
    assert int(got["pos"][0, 0]) == 0 and int(got["pos"].max()) > 0


@pytest.mark.parametrize("bench", ["kv_swap", "prefix_caching"])
def test_tier_bench_serves_like_its_sim(bench):
    """The tier benches' `serve_waves` at reduced width on the CPU: every
    request finishes, and the engine's counters (swap or prefix) are the
    port simulator's on the same stream."""
    from repro_torch.bench import kv_swap, prefix_caching

    base = ["--variant", "reduced", "--device", "cpu", "--b-max", "4",
            "--batch-buckets", "1,2,4", "--chunked", "--lanes", "2",
            "--chunk-budget", "64", "--max-context", "128", "--max-new",
            "8"]
    vocab = weights()[0].vocab_size
    if bench == "kv_swap":
        argv = kv_swap.swap_argv("swap", base) + [
            "--pool-tokens", "160", "--preempt", "swap"]
        waves = [kv_swap.prompts(vocab, n=5, lo=30, hi=50)]
        keys = ("swap_outs", "swap_ins", "swap_out_bytes", "preemptions")
    else:
        argv = prefix_caching.prefix_argv("on", base) + [
            "--pool-tokens", "1024"]
        waves = [[w[:40] + w[-6:] for w in wave]
                 for wave in prefix_caching.waves(vocab)[:2]]
        keys = ("prefix_hit_tokens", "prefix_query_tokens", "preemptions")
    out = kv_swap.serve_waves(argv, waves)
    m, sim = out["metrics"], out["sim"]
    assert m["finished"] == sum(len(w) for w in waves) and m[keys[0]] > 0
    assert {k: m[k] for k in keys + ("admitted", "oom_events")} \
        == {k: sim[k] for k in keys + ("admitted", "oom_events")}
    assert sim["sets"]["finished"] == list(range(m["finished"]))
