"""The VLM and enc-dec families in the port against the JAX package, with
the same weights (`params.from_jax_params`), reduced configs, fp32 on the
CPU: llama-3.2-vision-90b (a tanh-gated cross-attention layer to the
request's image embeddings after every self layer pair) and
seamless-m4t-medium (a bidirectional encoder over the request's audio
frames, a cross-attention layer after every decoder layer). Every `gate`
is set to 0.5 in the numpy tree before either package takes it: at its
initial zero the VLM's cross-attention adds nothing.

* `cross_kv`, `cross_attention` and `encode` against JAX.
* Chunked prefill with extras on the first chunk, then decode,
  contiguous and paged, against JAX `forward_train` and JAX `prefill` at
  rtol = atol = 2e-4 (tests/test_consistency.py).
* The engine's greedy tokens and structural counters against the JAX
  `Engine`'s with extras, in both cache layouts, on the `memory`,
  `chunked-2-lanes` and `static-preempt` (recompute preemption) setups of
  tests/test_torch_engine.py.
* The port's CLI submits the JAX CLI's requests, extras included.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import COUNTERS, SETUPS, _prompts

from repro.config.base import ServeConfig as JServeConfig
from repro.config.registry import get_config as jax_config
from repro.models import backbone as JB
from repro.models import layers as JL
from repro.models.model import build_model as jax_build
from repro.serving.engine import Engine as JEngine
from repro_torch.config.base import ServeConfig
from repro_torch.config.registry import get_config
from repro_torch.launch import serve as port_serve
from repro_torch.models import backbone as B
from repro_torch.models import layers as L
from repro_torch.models.model import build_model
from repro_torch.params import from_jax_params
from repro_torch.serving.engine import Engine
from repro_torch.serving.kv_cache import BlockManager

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ("llama-3.2-vision-90b", "seamless-m4t-medium")
#: the tree holding each family's cross layers
CROSS = {"llama-3.2-vision-90b": "cross_layers",
         "seamless-m4t-medium": "dec_cross"}
ENC_LEN = 16
_W = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many tiny ops: one intra-op thread serves them faster than a pool,
    and keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def weights(arch, seed=0):
    """(JAX config, JAX model, JAX params, port model, port params) of the
    reduced `arch`, every cross layer's gate at 0.5."""
    if (arch, seed) not in _W:
        jcfg = jax_config(arch, "reduced")
        jm = jax_build(jcfg, dtype=jnp.float32)
        tree = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
        gate = tree[CROSS[arch]]["attn"]["gate"]
        tree[CROSS[arch]]["attn"]["gate"] = np.full_like(gate, 0.5)
        m = build_model(get_config(arch, "reduced"), dtype=torch.float32,
                        device="cpu")
        _W[arch, seed] = (jcfg, jm, jax.tree.map(jnp.asarray, tree), m,
                          from_jax_params(tree))
    return _W[arch, seed]


def extras_key(jcfg):
    return "enc_frames" if jcfg.family.value == "encdec" else "images"


def one_layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_kv_and_cross_attention_match_jax(arch):
    jcfg, _, jp, m, p = weights(arch)
    rng = np.random.RandomState(3)
    B_, T, S, d = 2, 5, 11, jcfg.d_model
    enc, x = rng.randn(B_, S, d), rng.randn(B_, T, d)
    gated = arch == "llama-3.2-vision-90b"
    jlp = one_layer(jp[CROSS[arch]], 0)["attn"]
    lp = B.layer_params(p[CROSS[arch]], 0)["attn"]
    assert lp["gate"].dim() == 0 and float(lp["gate"]) == 0.5
    jk, jv = JL.cross_kv(jlp, jnp.asarray(enc, jnp.float32), jcfg)
    k, v = L.cross_kv(lp, torch.tensor(enc, dtype=torch.float32), m.cfg)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    want = JL.cross_attention(jlp, jnp.asarray(x, jnp.float32), jk, jv, None,
                              jcfg, gated=gated)
    got = L.cross_attention(lp, torch.tensor(x, dtype=torch.float32), k, v,
                            m.cfg, gated=gated)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # paged: the rows' cross K/V read in place through `rows`, padding row
    # on the (zero) sentinel
    pool_k = torch.zeros((4, S) + k.shape[2:])
    pool_v = torch.zeros_like(pool_k)
    pool_k[[2, 0]], pool_v[[2, 0]] = k, v
    got_p = L.cross_attention(lp, torch.tensor(x, dtype=torch.float32),
                              pool_k, pool_v, m.cfg, gated=gated,
                              rows=torch.tensor([2, 0]),
                              kpos=torch.zeros((4, S), dtype=torch.int32))
    torch.testing.assert_close(got_p, got, rtol=0, atol=0)


def test_encode_matches_jax():
    jcfg, _, jp, m, p = weights("seamless-m4t-medium")
    frames = np.random.RandomState(4).randn(2, 13, jcfg.d_model)
    want = JB.encode(jp, jnp.asarray(frames, jnp.float32), jcfg)
    got = B.encode(p, torch.tensor(frames, dtype=torch.float32), m.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_from_jax_params_carries_the_gates():
    """The stacked gates (one 0-d leaf a layer) and a lone 0-d leaf keep
    their shapes and values."""
    jcfg, _, jp, _, p = weights("llama-3.2-vision-90b")
    g = p["cross_layers"]["attn"]["gate"]
    assert tuple(g.shape) == (jcfg.num_cross_layers,)
    assert g.dtype == torch.float32 and bool((g == 0.5).all())
    one = from_jax_params({"gate": np.float32(0.25) * np.ones(())})["gate"]
    assert one.dim() == 0 and float(one) == 0.25
    assert set(p) == set(jp)


def paged_tables(m, B_, T, enc_len, bs=8):
    """A paged cache of B_ + 1 state slots and tables of T tokens a row,
    from the allocator."""
    bm = BlockManager(total_tokens=512, block_size=bs)
    tables = torch.full((B_, 8), -1, dtype=torch.int32)
    for i in range(B_):
        assert bm.allocate(i, 0, T)
        ids = bm.table(i)
        tables[i, :len(ids)] = torch.tensor(ids)
    return m.init_paged_cache(bm.num_blocks, bs, n_slots=B_ + 1,
                              enc_len=enc_len), tables


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_with_extras_and_decode_match_jax(arch, paged):
    """Chunks of 8 (extras on the first), then token-by-token decode,
    against JAX `forward_train`; the first chunk's logits also against
    JAX `prefill` on its contiguous cache. Paged, the rows' state slots
    are 2 and 0 and the sentinel slot stays zero."""
    jcfg, jm, jp, m, p = weights(arch, seed=1)
    rng = np.random.RandomState(0)
    B_, T, chunk = 2, 21, 8
    toks = rng.randint(0, jcfg.vocab_size, (B_, T))
    ex = rng.randn(B_, ENC_LEN, jcfg.d_model).astype(np.float32)
    key = extras_key(jcfg)
    full, _ = jm.forward_train(jp, {"tokens": jnp.asarray(toks),
                                    key: jnp.asarray(ex)}, remat=False)
    jcache = jm.init_cache(B_, 64, enc_len=ENC_LEN)
    jpos = jnp.broadcast_to(jnp.arange(chunk, dtype=jnp.int32), (B_, chunk))
    first, _ = jm.prefill(jp, jnp.asarray(toks[:, :chunk], jnp.int32), jpos,
                          jcache, {key: jnp.asarray(ex)})
    tt = torch.from_numpy(toks)
    pos = torch.arange(T, dtype=torch.int32)[None].repeat(B_, 1)
    rows = torch.tensor([2, 0])
    if paged:
        cache, tables = paged_tables(m, B_, T, ENC_LEN)
    else:
        cache = m.init_cache(B_, 64, enc_len=ENC_LEN, prefill_chunk=chunk)
    outs, split = [], T - 5
    for s in range(0, split, chunk):
        e = min(s + chunk, split)
        extras = {key: torch.from_numpy(ex)} if s == 0 else None
        if paged:
            lg, cache = m.prefill_paged(p, tt[:, s:e], pos[:, s:e], tables,
                                        cache, rows=rows, extras=extras)
        else:
            lg, cache = m.prefill(p, tt[:, s:e], pos[:, s:e], cache,
                                  extras=extras)
        outs.append(lg)
    for t in range(split, T):
        if paged:
            lg, cache = m.decode_step_paged(p, tt[:, t], pos[:, t], tables,
                                            cache, rows=rows)
        else:
            lg, cache = m.decode_step(p, tt[:, t], pos[:, t], cache)
        outs.append(lg[:, None])
    got = torch.cat(outs, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(full), **TOL)
    np.testing.assert_allclose(got[:, :chunk], np.asarray(first), **TOL)
    if paged:
        assert not bool(cache["cross_k"][:, -1].any())
        assert not bool(cache["cross_k"][:, 1].any())


def _serve_with_extras(eng, prompts, extras, max_new):
    hs = [eng.submit(q, max_new_tokens=max_new, extras=e)
          for q, e in zip(prompts, extras)]
    eng.run(max_steps=5000)
    return [h.output_tokens for h in hs], eng.summary()


@pytest.mark.parametrize("setup", ["memory", "chunked-2-lanes",
                                   "static-preempt"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_with_extras_matches_jax_engine(arch, setup):
    """tests/test_torch_engine.py's check with extras: the JAX engine on
    its contiguous cache, the port in both layouts, 16 cross keys a
    request; `static-preempt` preempts (recompute), and the victims'
    re-prefill reads their extras again."""
    jcfg, jm, jp, m, p = weights(arch)
    serve_kw, eng_kw, (seed, n, lo, hi), max_new = SETUPS[setup]
    prompts = _prompts(seed, n, lo, hi, jcfg.vocab_size)
    rng = np.random.RandomState(5)
    ex = [rng.randn(1, ENC_LEN, jcfg.d_model).astype(np.float32)
          for _ in prompts]
    key = extras_key(jcfg)
    want, jsum = _serve_with_extras(
        JEngine(jm, jp, JServeConfig(**serve_kw), enc_len=ENC_LEN, **eng_kw),
        prompts, [{key: jnp.asarray(e)} for e in ex], max_new)
    assert jsum["finished"] == n
    assert (jsum["preemptions"] > 0) == (setup == "static-preempt")
    for paged in (False, True):
        eng = Engine(m, p, ServeConfig(paged_kv=paged, **serve_kw),
                     enc_len=ENC_LEN, device="cpu", **eng_kw)
        got, s = _serve_with_extras(eng, prompts, [{key: e} for e in ex],
                                    max_new)
        assert got == want, (arch, setup, paged)
        assert {k: s[k] for k in COUNTERS} == {k: jsum[k] for k in COUNTERS}
        assert s["copy_rows"] == (0.0 if paged else jsum["copy_rows"])
        assert eng.graphs.steps and all(
            k[0] != "xchunk" or k[1] == 1 for k in eng.graphs.steps)


def test_engine_stages_extras_and_refuses_bad_ones():
    """An extras step stages the request's extras (cast to the working
    dtype) into its static input; a first chunk's step has its own key;
    extras of another shape or key, or for a family without them, raise."""
    jcfg, _, _, m, p = weights("llama-3.2-vision-90b")
    serve = ServeConfig(policy="memory", b_max=2, max_new_tokens=2,
                        kv_pool_tokens=512)
    eng = Engine(m, p, serve, max_context=32, buckets=(1, 2),
                 prefill_chunk=8, enc_len=ENC_LEN, device="cpu")
    x = np.random.RandomState(0).randn(1, ENC_LEN, jcfg.d_model)
    r = eng.submit(list(range(1, 12)), extras={"images": x})
    assert r.extras.dtype == torch.float32 and r.extras.device.type == "cpu"
    eng.run()
    st = eng.graphs.steps[("xchunk", 1, 8, 0)]
    np.testing.assert_array_equal(st.inputs["extras"].numpy(),
                                  x.astype(np.float32))
    assert ("chunk", 1, 3, 0) in eng.graphs.steps
    for bad in ({"images": x[:, :-1]}, {"enc_frames": x}):
        with pytest.raises(ValueError):
            eng.submit([1, 2, 3], extras=bad)
    g = build_model(get_config("granite-3-8b", "reduced"), torch.float32,
                    "cpu")
    plain = Engine(g, g.init(0), serve, max_context=32, buckets=(1, 2),
                   prefill_chunk=8, device="cpu")
    assert plain.enc_len == 0 and "cross_k" not in plain.cache
    with pytest.raises(ValueError):
        plain.submit([1, 2, 3], extras={"images": x})


def _record_submits(monkeypatch, engine_cls, log):
    """Patch `engine_cls` so that its submissions are recorded and `run`
    serves nothing."""
    submit = engine_cls.submit

    def rec(self, prompt, max_new_tokens=0, extras=None, **kw):
        log.append((list(prompt), max_new_tokens,
                    None if extras is None else
                    {k: np.asarray(v, np.float32) for k, v in
                     extras.items()}))
        return submit(self, prompt, max_new_tokens=max_new_tokens,
                      extras=extras, **kw)

    monkeypatch.setattr(engine_cls, "submit", rec)
    monkeypatch.setattr(engine_cls, "run", lambda self, *a, **k: 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_submits_the_jax_cli_requests(arch, monkeypatch, capsys):
    """Both CLIs, the same flags: the same prompts, max_new_tokens and
    extras (16 frames or patches a request, drawn after each prompt)."""
    from repro.launch import serve as jax_serve

    argv = ["--arch", arch, "--requests", "3", "--max-new", "3", "--seed",
            "7"]
    jax_log, port_log = [], []
    _record_submits(monkeypatch, JEngine, jax_log)
    _record_submits(monkeypatch, Engine, port_log)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jax_serve.main()
    eng = port_serve.run(port_serve.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    capsys.readouterr()
    assert eng.enc_len == port_serve.CLI_ENC_LEN
    assert len(port_log) == len(jax_log) == 3
    for (pp, pm, pe), (jp_, jm_, je) in zip(port_log, jax_log):
        assert (pp, pm) == (jp_, jm_)
        assert set(pe) == set(je) and all(
            pe[k].shape == (1, ENC_LEN, eng.cfg.d_model)
            and np.array_equal(pe[k], je[k]) for k in pe)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_extras_on_cpu(arch, capsys):
    """The port's CLI serves the reduced arch with extras in both layouts,
    chunked on two lanes."""
    for paged in ([], ["--paged"]):
        port_serve.main(["--device", "cpu", "--arch", arch, "--requests",
                         "3", "--max-new", "3", "--chunked", "--lanes",
                         "2"] + paged)
        assert "'finished': 3" in capsys.readouterr().out
