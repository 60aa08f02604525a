"""The plain reference against the port's CPU path on reduced
configurations, and the comparison that decides `correct`: a sound run
passes, a planted fault and the float8 control fail."""
import pytest
import torch

from perfbench import check
from perfbench.cell import run_cell
from perfbench.conftest import TINY, TINY_CELL, TINY_MIX
from perfbench.families import dense, dense_port

CFGS = {"untied": TINY,
        "tied_narrow_heads": dict(TINY, hidden_size=96, head_dim=16,
                                  num_attention_heads=4,
                                  tie_word_embeddings=True,
                                  rope_theta=1e6)}


@pytest.mark.parametrize("name", sorted(CFGS))
def test_reference_matches_the_port_on_the_cpu(name):
    from repro_torch.models.model import build_model

    c = dict(CFGS[name], source="test")
    w = dense.make_weights(c, 17, "cpu", torch.float32)
    model = build_model(dense_port.port_config(name, c),
                        dtype=torch.float32, device="cpu")
    toks = torch.randint(0, c["vocab_size"], (1, 40),
                         generator=torch.Generator().manual_seed(3))
    cache = model.init_cache(1, 64)
    pos = torch.arange(40, dtype=torch.int32)[None]
    port, _ = model.forward(w, toks, pos, cache)
    ref = dense.logits(c, w, [dense.Seq(toks[0].tolist(), range(40))])[0]
    assert torch.allclose(port[0], ref, atol=1e-4, rtol=1e-4)


def test_a_shared_prefix_gives_the_whole_sequences_logits():
    c = TINY
    w = dense.make_weights(c, 5, "cpu", torch.float32)
    toks = list(range(3, 53))
    whole = dense.logits(c, w, [dense.Seq(toks, range(30, 50))])[0]
    split = dense.logits(c, w, [dense.Seq(toks[:30]),
                                dense.Seq(toks[30:], range(20), 0, 30)])[1]
    assert torch.allclose(whole, split, atol=1e-5)


def test_weights_are_made_from_the_seed():
    a = dense.make_weights(TINY, 9, "cpu", torch.float32)
    b = dense.make_weights(TINY, 9, "cpu", torch.float32)
    c = dense.make_weights(TINY, 10, "cpu", torch.float32)
    assert torch.equal(a["layers"]["attn"]["wq"], b["layers"]["attn"]["wq"])
    assert not torch.equal(a["lm_head"], c["lm_head"])
    assert a["layers"]["mlp"]["w_down"].shape == (2, 128, 64)
    assert abs(a["embed"].std().item() - 0.02) < 0.002


def test_sample_keeps_the_longest():
    served = [(i, [1], [0] * (i % 7 + 1)) for i in range(20)]
    picked = check.sample(served, 2 ** 31 + 5, 4)
    assert picked[0][0] == 6 and len(picked) == 4
    assert picked == check.sample(served, 2 ** 31 + 5, 4)


@pytest.mark.parametrize("docs", [False, True], ids=["chat", "docqa"])
def test_a_sound_run_is_correct(tiny, docs):
    name = "tiny-cell"
    if docs:
        # documents prefilled in set-up, then asked about through shared
        # blocks: the reference runs each document once as a parent
        tiny.add_traffic("docs", dict(TINY_MIX, documents={"count": 2,
                                                           "tokens": 64}))
        cell = dict(TINY_CELL, serve=TINY_CELL["serve"] + ["--prefix-cache"])
        tiny.add_cell("tiny-docs", "tiny", "docs", cell)
        name = "tiny-docs"
    out = run_cell(tiny.bench(), name, 2 ** 31 + 77, 1.0, docs, "cpu")
    assert out["correct"]
    assert out["served_tokens_compared"] > 0
    assert list(out)[-1] == "check"
    assert out["check"]["widest_gap"]["value"] <= 1e-3
    if docs:
        m = out["metrics"]
        assert m["prefix_hit_rate"]["value"] > 50.0
        # the documents stay resident in the prefix index between requests
        assert m["kv_resident_share"]["value"] > m["kv_used_share"]["value"]


def test_a_token_altered_where_it_is_produced_fails(tiny, monkeypatch):
    """The timed path broken underneath: the sampler returns, for every
    other row, the id after its greedy pick."""
    import repro_torch.serving.engine as engine

    real = engine.sample

    def altered(logits, generator, temperature):
        out = real(logits, generator, temperature)
        out[::2] = (out[::2] + 1) % logits.shape[-1]
        return out

    monkeypatch.setattr(engine, "sample", altered)
    out = run_cell(tiny.bench(), "tiny-cell", 2 ** 31 + 77, 1.0, False,
                   "cpu")
    assert not out["correct"]
    assert out["check"]["widest_gap"]["value"] > 1e-3


def test_the_float8_control_fails_the_limit(tiny):
    """The control in the program's place comes out not correct through
    the run's own verdict, where the program's own tokens pass."""
    out = run_cell(tiny.bench(), "tiny-cell", 4, 1.0, False, "cpu",
                   control=True)
    limit = out["check"]["widest_gap"]["limit"]
    assert not out["correct"]
    assert out["check"]["widest_gap"]["value"] > limit
    assert out["program_widest_gap"] <= limit


@pytest.mark.cuda
def test_a_traced_run_on_the_card(tiny, card):
    """On the card: the tiny cell in bf16, traced: the device's busy time
    and the per-layer metrics come back."""
    tiny.add_config("tiny-bf16", dict(TINY, torch_dtype="bfloat16"))
    cell = dict(TINY_CELL)
    tiny.add_cell("tiny-card", "tiny-bf16", "mix", dict(
        cell, check={"sample_requests": 4, "gap_limit": 0.5}))
    out = run_cell(tiny.bench(), "tiny-card", 3, 3.0, True, "cuda")
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert "device_idle_share" in out["metrics"]
    assert out["correct"], out["check"]
