"""The port's block allocator against the JAX package's `BlockManager`
(DESIGN §9-§11, §14): seeded random call sequences over allocation, free,
prefix sharing, copy-on-write, swap and shadow epochs give the same return
values and the same state (free-list order, block ids, refcounts, the
prefix index, the swap ledger, every counter) after every call. Then the
shadow-epoch properties of tests/test_async_overlap.py on the port's
allocator.
"""
import random as _random

import pytest
from _hypothesis_compat import given, settings, strategies as st

from repro.config.registry import get_config as jax_config
from repro.serving import kv_cache as jkv
from repro_torch.config.registry import get_config
from repro_torch.serving import kv_cache as pkv
from repro_torch.serving.kv_cache import BlockManager


def _state(bm, port: bool):
    """Every piece of allocator state, under the package's field names."""
    if port:
        f = (bm._free_list, bm._parked, bm.block_tables, bm.refcount,
             bm._block_hash, bm._prefix_index, bm._lru_cache,
             bm._commit_cursor, bm._evicted_for_reuse, bm._swap_free_list,
             bm.swapped_block_tables, bm._in_epoch)
    else:
        f = (bm._free, bm._deferred, bm.tables, bm.ref, bm._hash_of,
             bm._index, bm._cached, bm._commit, bm._released, bm._swap_free,
             bm.swapped_tables, bm._epoch_open)
    free, parked, tables, ref, hash_of, index, cached, commit, released, \
        swap_free, swapped, epoch = f
    return dict(
        free=list(free), parked=list(parked),
        tables={r: list(t) for r, t in tables.items()}, ref=dict(ref),
        hash_of=dict(hash_of), index=dict(index), cached=list(cached),
        commit=dict(commit), released=list(released),
        swap_free=list(swap_free),
        swapped={r: list(t) for r, t in swapped.items()}, epoch=epoch,
        counters=(bm.swap_out_blocks, bm.swap_in_blocks, bm.swapped_peak,
                  bm.prefix_hit_tokens, bm.prefix_query_tokens,
                  bm.cache_evictions, bm.cow_copies),
        queries=(bm.free_blocks, bm.free_tokens, bm.physical_free_blocks,
                 bm.cached_blocks, bm.logical_used_tokens,
                 bm.physical_used_tokens, bm.prefix_hit_rate,
                 bm.host_free_blocks, bm.swapped_blocks,
                 bm.swapped_tokens))


def _call(bm, name, *args):
    """(return value, exception type) of one call."""
    try:
        return getattr(bm, name)(*args), None
    except RuntimeError as e:
        return None, type(e)


def _prompts(rng, n, vocab=6, bs=4):
    """Prompts sharing block-aligned prefixes, so the index gets hits."""
    roots = [[rng.randrange(vocab) for _ in range(3 * bs)] for _ in range(3)]
    out = {}
    for rid in range(n):
        base = list(rng.choice(roots))[:rng.choice((bs, 2 * bs, 3 * bs))]
        out[rid] = base + [rng.randrange(vocab)
                           for _ in range(rng.randrange(0, 2 * bs))]
    return out


def _sequence(seed, pool_blocks, prefix, swap, n_ops=250, bs=4):
    """Drive both allocators through one seeded call sequence, checking
    every return value and the whole state after each call."""
    rng = _random.Random(seed)
    kw = dict(prefix_cache=prefix, swap_space_blocks=swap)
    ours = BlockManager(pool_blocks * bs, bs, **kw)
    ref = jkv.BlockManager(pool_blocks * bs, bs, **kw)
    prompts = _prompts(rng, 12, bs=bs)
    hits = {}
    for i in range(n_ops):
        rid = rng.randrange(12)
        toks = prompts[rid]
        op = rng.choice(("admit", "admit", "allocate", "grow", "free",
                         "free", "acquire_prefix", "commit_prefill",
                         "cow_range", "cow_range", "swap_out", "swap_in",
                         "take_released", "shadow_begin", "shadow_commit",
                         "shadow_rollback", "admission_verdict",
                         "can_allocate"))
        calls = [(op, ())]
        if op == "admit":
            # the engine's admission: map the shared prefix, allocate the
            # rest, register the prompt's full blocks once prefilled
            if rid in ref.tables or rid in ref.swapped_tables:
                continue
            calls = [("acquire_prefix", (rid, toks)),
                     ("allocate", (rid, 0, len(toks) + 1)),
                     ("commit_prefill", (rid, toks, len(toks)))]
        elif op == "allocate":
            calls = [(op, (rid, 0, len(toks) + 1))]
        elif op == "grow":
            calls = [("allocate", (rid, rng.randrange(0, 4 * bs), 1))]
        elif op == "free":
            calls = [(op, (rid,))]
        elif op == "acquire_prefix":
            if rid in ref.swapped_tables:
                continue     # a swapped request is never re-admitted as new
            calls = [(op, (rid, toks))]
        elif op == "commit_prefill":
            calls = [(op, (rid, toks, rng.randrange(0, len(toks) + 2)))]
        elif op == "cow_range":
            if ours.free_blocks < 3:
                continue     # the callers hold headroom before a COW write
            s = rng.randrange(0, len(toks) + 1)
            calls = [(op, (rid, s, s + rng.randrange(1, 2 * bs)))]
        elif op == "swap_out":
            if not ref.can_swap_out(rid, 8):
                assert not ours.can_swap_out(rid, 8), (seed, i)
                continue
            assert ours.can_swap_out(rid, 8), (seed, i)
            calls = [(op, (rid,))]
        elif op == "swap_in":
            if rid not in ref.swapped_tables or not ref.can_swap_in(rid):
                assert ours.can_swap_in(rid) == ref.can_swap_in(rid)
                continue
            calls = [(op, (rid,))]
        elif op == "admission_verdict":
            calls = [(op, (rng.randrange(0, pool_blocks + 2),
                           rng.choice((0, 4))))]
        elif op == "can_allocate":
            calls = [(op, (rng.randrange(0, 3 * bs), rng.randrange(1, 2 * bs),
                           rid))]
        for name, args in calls:
            got, want = _call(ours, name, *args), _call(ref, name, *args)
            assert got == want, (seed, i, name, args)
            if name == "acquire_prefix" and want[0]:
                ours.note_prefix_query(len(toks), want[0])
                ref.note_prefix_query(len(toks), want[0])
            assert _state(ours, True) == _state(ref, False), \
                (seed, i, name, args)
            # calls that did something (a hit, a copy, a restore, ...)
            if want[1] is None and (want[0] not in (0, [], False, None)
                                    or name.startswith("shadow_")
                                    or name == "free"):
                key = "cow" if name == "cow_range" else name
                hits[key] = hits.get(key, 0) + 1
    hits["evictions"] = ref.cache_evictions
    return hits


@pytest.mark.parametrize("swap", [0, 6])
@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_call_sequences_match_jax(seed, prefix, swap):
    hits = _sequence(seed, pool_blocks=10 + seed, prefix=prefix, swap=swap)
    assert hits.get("allocate") and hits.get("free") \
        and hits.get("shadow_begin"), hits


def test_the_sequences_reach_every_path():
    """Across the seeds the sequences evict cached blocks, copy on write,
    swap out and in, and roll epochs back: the states compared above are
    not trivial ones."""
    hits = {}
    for seed in range(6):
        for k, n in _sequence(seed, pool_blocks=10 + seed, prefix=True,
                              swap=6).items():
            hits[k] = hits.get(k, 0) + n
    assert all(hits.get(k, 0) > 0 for k in (
        "evictions", "cow", "swap_out", "swap_in", "shadow_rollback",
        "acquire_prefix")), hits


@pytest.mark.parametrize("arch", ["granite-3-8b", "mamba2-2.7b",
                                  "recurrentgemma-9b"])
def test_feature_gates_match_jax(arch):
    for variant in ("reduced", "full"):
        ours, ref = get_config(arch, variant), jax_config(arch, variant)
        assert pkv.prefix_cache_supported(ours) \
            == jkv.prefix_cache_supported(ref)
        assert pkv.swap_supported(ours) == jkv.swap_supported(ref)


def test_reset_matches_jax():
    ours = BlockManager(64, 4, prefix_cache=True, swap_space_blocks=4)
    ref = jkv.BlockManager(64, 4, prefix_cache=True, swap_space_blocks=4)
    for bm in (ours, ref):
        r = _random.Random(3)
        bm.shadow_begin()
        for rid in range(5):
            toks = [r.randrange(4) for _ in range(9)]
            bm.allocate(rid, 0, 10)
            bm.commit_prefill(rid, toks, 9)
        bm.free(2)
        bm.reset()
    assert _state(ours, True) == _state(ref, False)


# ---------------------------------------------------------------------------
# shadow-epoch properties (tests/test_async_overlap.py on the port)


def _drive(bm, rng, n_ops, twin=None, commit_every=0):
    """Random allocate/free traffic; mirrored onto `twin` (epoch-free)
    when given. Returns per-op (free_blocks, physical) observations."""
    live = []
    obs = []
    for i in range(n_ops):
        op = rng.random()
        if op < 0.55 or not live:
            rid = rng.randrange(1000)
            if rid in bm.block_tables or rid in bm.swapped_block_tables:
                continue
            toks = rng.randrange(1, 4 * bm.block_size)
            ok = bm.allocate(rid, 0, toks)
            if twin is not None:
                assert twin.allocate(rid, 0, toks) == ok
            if ok:
                live.append(rid)
            else:
                bm.free(rid)
                if twin is not None:
                    twin.free(rid)
        else:
            rid = live.pop(rng.randrange(len(live)))
            bm.free(rid)
            if twin is not None:
                twin.free(rid)
        if commit_every and i % commit_every == commit_every - 1:
            bm.shadow_commit()
            bm.shadow_begin()
        obs.append((bm.free_blocks, bm.physical_free_blocks))
        if twin is not None:
            assert (twin.free_blocks, twin.physical_free_blocks) == obs[-1]
    return obs


@given(st.integers(0, 10_000), st.integers(4, 24), st.integers(0, 5))
@settings(max_examples=40, deadline=None)
def test_epoch_count_invariance(seed, pool_blocks, commit_every):
    """An allocator running open shadow epochs reports the same headroom
    and allocation verdicts as an epoch-free twin: epochs change which
    ids are reused, never whether an allocation succeeds."""
    rng = _random.Random(seed)
    bm = BlockManager(pool_blocks * 16, 16)
    twin = BlockManager(pool_blocks * 16, 16)
    bm.shadow_begin()
    _drive(bm, rng, 60, twin=twin, commit_every=commit_every)
    bm.shadow_commit()
    assert (bm.free_blocks, bm.physical_free_blocks) \
        == (twin.free_blocks, twin.physical_free_blocks)


@given(st.integers(0, 10_000), st.integers(4, 24))
@settings(max_examples=40, deadline=None)
def test_shadow_rollback_restores(seed, pool_blocks):
    """begin -> arbitrary mutations -> rollback is a no-op, free order
    included."""
    rng = _random.Random(seed)
    bm = BlockManager(pool_blocks * 16, 16, prefix_cache=True)
    _drive(bm, rng, 20)
    before = _state(bm, True)
    bm.shadow_begin()
    _drive(bm, rng, 30)
    bm.shadow_rollback()
    assert _state(bm, True) == before
    with pytest.raises(RuntimeError):
        bm.shadow_rollback()
    bm.shadow_begin()
    bm.shadow_commit()


@given(st.integers(0, 10_000), st.integers(4, 16))
@settings(max_examples=30, deadline=None)
def test_shadow_commit_flushes_in_free_order(seed, pool_blocks):
    """Commit returns every parked block to the free list (parked order
    kept at the reuse end), leaves totals unchanged, and is legal with no
    epoch open."""
    rng = _random.Random(seed)
    bm = BlockManager(pool_blocks * 16, 16)
    bm.shadow_commit()
    bm.shadow_begin()
    _drive(bm, rng, 25)
    free_before = bm.free_blocks
    parked = list(bm._parked)
    bm.shadow_commit()
    assert bm._parked == []
    assert bm.free_blocks == free_before
    assert bm._free_list[len(bm._free_list) - len(parked):] == parked
    with pytest.raises(RuntimeError):
        bm.shadow_rollback()


def test_deferred_reused_only_after_free_list_drains():
    """While the free list is non-empty allocation never takes a parked
    block; once it drains, parked blocks are reused oldest first."""
    bm = BlockManager(8 * 16, 16)
    assert bm.allocate(1, 0, 3 * 16)
    bm.shadow_begin()
    bm.free(1)
    parked = list(bm._parked)
    assert len(parked) == 3
    assert bm.allocate(2, 0, 5 * 16)
    assert not any(b in parked for b in bm.block_tables[2])
    assert bm.allocate(3, 0, 2 * 16)
    assert bm.block_tables[3] == parked[:2]
    bm.shadow_commit()


def test_epoch_double_begin_raises():
    bm = BlockManager(4 * 16, 16)
    bm.shadow_begin()
    with pytest.raises(RuntimeError):
        bm.shadow_begin()
    bm.shadow_rollback()
