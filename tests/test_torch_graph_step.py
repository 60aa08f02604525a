"""The compiled serving step of the port, on the CPU (reduced configs,
fp32): the static-shape write index against the `nonzero` index it
replaced, all-padding steps (the ones `Engine.warmup` captures) against
the cache, the reference's TBT sample, and the staged step inputs against
the ones the eager loop built before. Replay against eager runs on the
card, in `tests/test_torch_cuda.py`.
"""
import numpy as np
import pytest
import torch

from repro_torch.config.base import ServeConfig
from repro_torch.config.registry import get_config
from repro_torch.models import layers as L
from repro_torch.models.backbone import STATE_KEYS, phys_cache_len
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine
from repro_torch.serving.graphs import Step

FAMILIES = ("granite-3-8b", "mamba2-2.7b", "recurrentgemma-9b")


# ---------------------------------------------------------------------------
# the write index: the slots the `nonzero` index wrote, and nothing else


def _nonzero_contiguous(cache_k, cache_pos, k, positions):
    """The eager loop's write: only the real tokens, found by `nonzero`."""
    S = cache_k.shape[1]
    rows, toks = (positions >= 0).nonzero(as_tuple=True)
    slots = positions[rows, toks] % S
    cache_k[rows, slots] = k[rows, toks]
    cache_pos[rows, slots] = positions[rows, toks]


def _nonzero_paged(pool_k, pool_pos, k, positions, tables, bs):
    MB = tables.shape[1]
    blk = (positions // bs).clamp(0, MB - 1)
    phys = tables.gather(1, blk.to(torch.int64))
    rows, toks = ((positions >= 0) & (phys >= 0)).nonzero(as_tuple=True)
    flat = phys[rows, toks] * bs + positions[rows, toks] % bs
    NB = pool_k.shape[0]
    pool_k.view((NB * bs,) + pool_k.shape[2:])[flat] = k[rows, toks]
    pool_pos.view(-1)[flat] = positions[rows, toks]


def _rows(*rows):
    return torch.tensor(rows, dtype=torch.int32)


#: name -> (S, positions (B, T)); -1 = padding
CONTIGUOUS = {
    # a prefill chunk, a partly padded row, an all-padding row
    "chunk": (32, _rows([5, 6, 7, 8, 9, 10], [0, 1, 2, 3, -1, -1],
                        [-1] * 6)),
    # decode rows and padding rows of a bucket
    "decode": (32, _rows([7], [-1], [31], [-1])),
    # recurrentgemma-reduced's window ring (built in the test, from S): a
    # chunk across the wrap, a partly padded chunk a lap later
    "ring": (None, None),
    # the warmup inputs: every token padding
    "warmup": (32, torch.full((3, 6), -1, dtype=torch.int32)),
}


@pytest.mark.parametrize("case", sorted(CONTIGUOUS))
@pytest.mark.parametrize("seed", [0, 1])
def test_contiguous_write_index_writes_the_nonzero_slots(case, seed):
    S, positions = CONTIGUOUS[case]
    if S is None:
        # recurrentgemma-reduced's window ring for 6-token chunks
        cfg = get_config("recurrentgemma-9b", "reduced")
        S = phys_cache_len(cfg, 256, chunk=6)
        assert S < 256
        positions = _rows(list(range(S - 3, S + 3)),
                          [2 * S + 5, 2 * S + 6, 2 * S + 7, -1, -1, -1],
                          [-1] * 6)
    g = torch.Generator().manual_seed(seed)
    B, T = positions.shape
    cache_k = torch.randn((B, S, 2, 4), generator=g)
    cache_pos = torch.randint(-1, 40, (B, S), generator=g, dtype=torch.int32)
    k = torch.randn((B, T, 2, 4), generator=g)
    want_k, want_pos = cache_k.clone(), cache_pos.clone()
    _nonzero_contiguous(want_k, want_pos, k, positions)
    widx = L.cache_write_index(positions, S)
    assert all(t.shape == (B, T) for t in widx)
    L.cache_put(cache_k, widx, k)
    L.cache_put(cache_pos, widx, positions)
    assert torch.equal(cache_k, want_k) and torch.equal(cache_pos, want_pos)


def test_contiguous_write_index_refuses_a_chunk_longer_than_the_row():
    with pytest.raises(ValueError):
        L.cache_write_index(torch.zeros((1, 9), dtype=torch.int32), 8)


#: name -> (positions (B, T), tables (B, MB)); block size 4, 6 blocks + spare
PAGED = {
    # a chunk across a hole (-1 entry) in its row's table, a padded row, a
    # row with no blocks at all
    "chunk": (_rows([2, 3, 4, 5, 6, 7, 8, 9], [0, 1, 2, 3, 4, -1, -1, -1],
                    [0, 1, 2, 3, 4, 5, 6, 7]),
              _rows([3, -1, 5, -1], [0, 2, -1, -1], [-1] * 4)),
    "decode": (_rows([9], [-1], [4]),
               _rows([1, 4, 3, -1], [-1] * 4, [2, 5, -1, -1])),
    "warmup": (torch.full((2, 8), -1, dtype=torch.int32),
               torch.full((2, 4), -1, dtype=torch.int32)),
}


@pytest.mark.parametrize("case", sorted(PAGED))
@pytest.mark.parametrize("seed", [0, 1])
def test_paged_write_index_writes_the_nonzero_slots(case, seed):
    positions, tables = PAGED[case]
    bs, NB = 4, 6
    g = torch.Generator().manual_seed(seed)
    B, T = positions.shape
    pool_k = torch.randn((NB + 1, bs, 2, 4), generator=g)
    pool_pos = torch.randint(-1, 40, (NB + 1, bs), generator=g,
                             dtype=torch.int32)
    pool_pos[NB] = -1
    k = torch.randn((B, T, 2, 4), generator=g)
    want_k, want_pos = pool_k.clone(), pool_pos.clone()
    _nonzero_paged(want_k, want_pos, k, positions, tables, bs)
    flat, real = L.paged_write_index(positions, tables, bs, spare=NB)
    assert flat.shape == real.shape == (B, T)
    L._pool_write(pool_k, flat, k)
    pool_pos.view(-1)[flat] = torch.where(real, positions, -1)
    # every block a table can name is the nonzero index's; the spare block
    # took the rest and its positions stay empty
    assert torch.equal(pool_k[:NB], want_k[:NB])
    assert torch.equal(pool_pos, want_pos)
    assert bool((pool_pos[NB] == -1).all())


# ---------------------------------------------------------------------------
# engines on the CPU


def _engine(arch, paged, chunked=True, lanes=2, **kw):
    cfg = get_config(arch, "reduced")
    m = build_model(cfg, torch.float32, "cpu")
    serve = ServeConfig(policy="memory", b_max=4, max_new_tokens=5,
                        kv_pool_tokens=1024, block_size=8,
                        chunked_prefill=chunked, chunk_budget_tokens=16,
                        n_prefill_lanes=lanes, paged_kv=paged)
    return Engine(m, m.init(0), serve, max_context=64, buckets=(1, 2, 4),
                  prefill_chunk=8, device="cpu", **kw)


def _prompts(eng, n, lo=5, hi=30, seed=0):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, eng.cfg.vocab_size,
                                      size=rng.randint(lo, hi))))
            for _ in range(n)]


def _fill_cache(eng, seed=0):
    """Random contents in every visible place: K/V, positions (the paged
    spare block's stay empty) and the state rows (the paged sentinel's stay
    zero)."""
    g = torch.Generator().manual_seed(seed)
    for k, v in eng.cache.items():
        if k == "pos":
            v.copy_(torch.randint(-1, 60, v.shape, generator=g,
                                  dtype=v.dtype))
            if eng.paged:
                v[-1] = -1
        else:
            v.copy_(torch.randn(v.shape, generator=g, dtype=v.dtype))
            if eng.paged and k in STATE_KEYS:
                v[:, eng.n_slots] = 0


def test_cuda_graphs_on_the_cpu_raise():
    with pytest.raises(ValueError):
        _engine("granite-3-8b", False, cuda_graphs=True)
    eng = _engine("granite-3-8b", False)
    assert not eng.graphs.enabled


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_padding_steps_change_no_visible_slot(arch, paged):
    """Every step `warmup` builds, run on its all-padding inputs as before
    a capture (the contiguous rows' state kept across the run), leaves
    every K/V slot, position and state row as it was; the paged spare
    block alone takes writes."""
    eng = _engine(arch, paged)
    eng.warmup()
    keys = set(eng.graphs.steps)
    want = {("decode", b) for b in (1, 2, 4)}
    want |= {("chunk", 1, 8, -1), ("chunk", 2, 8, -1)} if paged else \
        {("chunk", 1, 8, 4), ("chunk", 1, 8, 5), ("chunk", 2, 8, -1)}
    assert keys == want
    _fill_cache(eng)
    before = {k: v.clone() for k, v in eng.cache.items()}
    for st in eng.graphs.steps.values():
        with eng._state_kept(st):
            out = st.run()
        assert out.shape == (st.inputs["tokens"].shape[0],
                             eng.cfg.vocab_size)
        for k, v in eng.cache.items():
            got, was = (v[:, :-1], before[k][:, :-1]) \
                if paged and k in ("k", "v") else (v, before[k])
            assert torch.equal(got, was), (st.key, k)


def _serve(eng, prompts):
    hs = [eng.submit(p) for p in prompts]
    decoded = []
    while True:
        n = eng.decode_steps
        if not eng.step():
            break
        decoded.append(eng.decode_steps > n)
    return hs, decoded


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_tbt_sample_is_the_readback_wait(paged):
    """`_retire` samples TBT as the reference does: the interval's readback
    wait (its device time), for the controller and for each request."""
    eng = _engine("granite-3-8b", paged)
    hs, decoded = _serve(eng, _prompts(eng, 5))
    waits = [1e3 * d for d, dec in zip(eng.step_device_trace, decoded)
             if dec]
    assert len(waits) == eng.decode_steps > 0
    assert eng.tbt_trace == waits
    # Alg 2's window holds the newest samples: the same waits
    assert list(eng.tel.tbt) == waits[-len(eng.tel.tbt):]
    for h in hs:
        assert h.tbt_samples and set(h.tbt_samples) <= set(waits)


def _legacy_inputs(eng, kind, reqs, take):
    """The step inputs as the eager loop built them before staging
    (`torch.tensor` of host lists, the pending first tokens spliced in by
    list indexing)."""
    def tables(rs, pad_to=0):
        tbl = np.full((max(pad_to, len(rs), 1), eng.max_blocks), -1,
                      np.int32)
        for i, r in enumerate(rs):
            ids = eng.blocks.table(r.rid)
            tbl[i, :len(ids)] = ids
        return torch.from_numpy(tbl)

    if kind == "decode":
        n = len(eng.active)
        bucket = take
        toks = [0 if r.output_tokens[-1] is None else r.output_tokens[-1]
                for r in eng.active] + [0] * (bucket - n)
        pend = [(i, eng._pending_tok[r.rid]) for i, r in
                enumerate(eng.active) if r.output_tokens[-1] is None]
        lens = [r.context_len - 1 for r in eng.active] + [-1] * (bucket - n)
        tt = torch.tensor(toks)
        if pend:
            tt[[i for i, _ in pend]] = torch.stack([v for _, v in pend])
        out = {"tokens": tt[:, None],
               "positions": torch.tensor(lens, dtype=torch.int32)[:, None]}
        if eng.paged:
            out["block_table"] = tables(eng.active, bucket)
            out["slots"] = torch.tensor([r.slot for r in eng.active]
                                        + [eng.n_slots] * (bucket - n))
        return out
    out = {"tokens": torch.tensor(
        [r.prompt_tokens[r.prefill_pos:r.prefill_pos + take] for r in reqs]),
        "positions": torch.tensor(
            [list(range(r.prefill_pos, r.prefill_pos + take)) for r in reqs],
            dtype=torch.int32)}
    if eng.paged:
        out["block_table"] = tables(reqs)
    if eng.paged or len(reqs) > 1:
        out["slots"] = torch.tensor([r.slot for r in reqs])
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_staged_inputs_are_the_eager_loops_inputs(arch, paged, monkeypatch):
    """Every step of a served run (decode with first tokens spliced in,
    one- and two-lane chunks) runs on the inputs the eager loop built."""
    eng = _engine(arch, paged)
    calls = {}
    seen = {"decode": 0, "pending": 0, "chunk": 0, "lanes": 0}
    prefill_group, decode_once, run = (Engine._prefill_group,
                                       Engine._decode_once, Step.run)

    def pg(self, reqs, take):
        calls["now"] = ("chunk", reqs, take)
        return prefill_group(self, reqs, take)

    def do(self, rec):
        n = len(self.active)
        calls["now"] = ("decode", None,
                        min(b for b in self.buckets if b >= n))
        return decode_once(self, rec)

    def checked_run(st, eager=False):
        kind, reqs, take = calls.pop("now")
        want = _legacy_inputs(eng, kind, reqs, take)
        assert set(want) == set(st.inputs), st.key
        for k, v in want.items():
            assert torch.equal(st.inputs[k], v.to(st.inputs[k].dtype)), \
                (st.key, k)
        seen[kind] += 1
        seen["pending"] += kind == "decode" and any(
            r.output_tokens[-1] is None for r in eng.active)
        seen["lanes"] += kind == "chunk" and len(reqs) > 1
        return run(st, eager)

    monkeypatch.setattr(Engine, "_prefill_group", pg)
    monkeypatch.setattr(Engine, "_decode_once", do)
    monkeypatch.setattr(Step, "run", checked_run)
    hs, _ = _serve(eng, _prompts(eng, 6, lo=5, hi=20, seed=1))
    assert all(len(h.output_tokens) == 5 for h in hs)
    assert all(seen[k] > 0 for k in seen), seen


def test_staging_copies_each_input_from_its_own_slice():
    """An interval's staged copies never share arena bytes, also past an
    outgrown arena, until the rewind after the readback."""
    from repro_torch.serving.graphs import Staging

    st = Staging(torch.device("cpu"), nbytes=64)
    dsts = [torch.empty(n, dtype=torch.int64) for n in (3, 5, 20)]
    for i, d in enumerate(dsts):
        st.copy(d, np.arange(d.numel()) + 100 * i)
    for i, d in enumerate(dsts):
        assert d.tolist() == list(range(100 * i, 100 * i + d.numel()))
    assert st._outgrown and st._off > 0
    st.rewind()
    assert not st._outgrown and st._off == 0
