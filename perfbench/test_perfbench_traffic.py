"""The traffic generator: the same seed gives the same requests, every seed
the mix's schedule of sizes and arrivals, and the realised rate is the
rate."""
import math

import pytest

from perfbench import traffic

CHAT = {"arrivals": {"process": "poisson"},
        "prompt_tokens": {"dist": "lognormal", "mean": 512, "cv": 0.6,
                          "min": 32, "max": 2048},
        "output_tokens": {"dist": "lognormal", "mean": 192, "cv": 0.6,
                          "min": 16, "max": 1024}}
BIG_SEED = 2 ** 31 + 12345


def shape(p):
    return [(q.due, q.prompt_len, q.max_new, q.doc) for q in p.window]


def test_same_seed_same_requests_and_tokens():
    a = traffic.plan(CHAT, 2.0, BIG_SEED, 30.0, 5.0, 49155)
    b = traffic.plan(CHAT, 2.0, BIG_SEED, 30.0, 5.0, 49155)
    assert shape(a) == shape(b)
    assert [shape_w for shape_w in map(lambda q: (q.due, q.prompt_len),
                                       a.warm)] == \
        [(q.due, q.prompt_len) for q in b.warm]
    assert a.prompt(a.window[3]) == b.prompt(b.window[3])
    assert all(0 <= t < 49155 for t in a.prompt(a.window[0]))


def test_seeds_share_the_schedule_not_the_tokens():
    a = traffic.plan(CHAT, 2.0, 1, 30.0, 5.0, 49155)
    b = traffic.plan(CHAT, 2.0, 2, 30.0, 5.0, 49155)
    assert shape(a) == shape(b)
    assert a.prompt(a.window[0]) != b.prompt(b.window[0])
    # the mix's schedule seed orders the same sizes otherwise
    c = traffic.plan(dict(CHAT, schedule_seed=9), 2.0, 1, 30.0, 5.0, 49155)
    assert shape(c) != shape(a)
    assert sorted(q.prompt_len for q in a.window) == \
        sorted(q.prompt_len for q in c.window)
    assert sorted(q.max_new for q in a.window) == \
        sorted(q.max_new for q in c.window)


@pytest.mark.parametrize("rate,seconds", [(1.35, 51.0), (4.0, 30.0),
                                          (0.5, 10.0)])
def test_realised_rate(rate, seconds):
    p = traffic.plan(CHAT, rate, 7, seconds, 8.0, 100)
    assert len(p.window) == round(rate * seconds)
    assert all(0.0 <= q.due < seconds for q in p.window)
    assert all(-8.0 <= q.due < 0.0 for q in p.warm)
    assert len(p.warm) == round(rate * 8.0)
    dues = sorted(q.due for q in p.window)
    # the last arrival falls within a mean gap of the window's end
    assert seconds - dues[-1] < 2.0 / rate


def test_lengths_are_the_distributions_quantiles():
    xs = traffic.lengths(CHAT["prompt_tokens"], 1000)
    assert xs == sorted(xs) and xs[0] >= 32 and xs[-1] <= 2048
    assert abs(sum(xs) / len(xs) - 512) < 15
    assert traffic.lengths({"dist": "fixed", "value": 7}, 3) == [7, 7, 7]
    gaps = traffic.unit_gaps(10000)
    assert abs(sum(gaps) / len(gaps) - 1.0) < 1e-3


def test_square_wave_rate_by_time_rescaling():
    mix = dict(CHAT, arrivals={"process": "square_wave", "base": 0.5,
                               "burst": 2.0, "period_s": 10.0,
                               "duty": 0.2})
    r = traffic.Rate(mix["arrivals"], 4.0)
    assert r.integral(10.0) == pytest.approx(2 * 8 + 8 * 2)
    for s in (0.0, 3.0, 16.0, 40.0, 77.7):
        assert r.integral(r.inverse(s)) == pytest.approx(s)
    p = traffic.plan(mix, 4.0, 3, 30.0, 0.0, 100)
    assert len(p.window) == 96
    burst = sum(1 for q in p.window if (q.due % 10.0) < 2.0)
    # 8 a second for 2 s of each 10 against 2 a second for 8
    assert abs(burst - 48) <= 8


def test_documents_are_shared_in_equal_parts():
    mix = dict(CHAT, documents={"count": 4, "tokens": 64},
               prompt_tokens={"dist": "fixed", "value": 5})
    p = traffic.plan(mix, 3.0, 11, 20.0, 2.0, 500)
    assert len(p.documents) == 4 and all(len(d) == 64 for d in p.documents)
    docs = [q.doc for q in p.window]
    assert sorted(docs.count(k) for k in range(4)) == [15, 15, 15, 15]
    q = p.window[0]
    prompt = p.prompt(q)
    assert prompt[:64] == p.documents[q.doc] and len(prompt) == 69


def test_closed_loop_plan_has_no_due_times():
    mix = dict(CHAT, arrivals={"process": "closed", "clients": 8})
    p = traffic.plan(mix, 0.0, 5, 10.0, 2.0, 100)
    assert p.clients == 8 and not p.warm
    assert all(q.due is None for q in p.window)
    assert len(p.window) >= 64 * 8


def test_lognormal_parameters_are_the_frozen_copy():
    mu, s = traffic._lognorm(512.0, 0.6)
    assert math.exp(mu + s * s / 2) == pytest.approx(512.0)
    assert math.sqrt(math.exp(s * s) - 1) == pytest.approx(0.6)
