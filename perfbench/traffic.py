"""The one traffic generator: it reads a mix from `traffic/<name>.json`
and the cell's rate, and makes the requests of a run from `--seed`.

Every seed gets the same work. Lengths are the quantiles of their
distribution at (i + 0.5) / n, clipped, and the gaps between arrivals the
quantiles of the unit exponential, both permuted by the mix's own
`schedule_seed` (0 unless the file names one): the schedule of sizes and
arrivals is the mix's. The run's seed draws what the requests say (their
token ids and the documents) and, elsewhere, the weights. Permuting the
schedule by the run's seed moved the tokens a window completes by 6% and
the TTFT tail by 17% between seeds of the granite-chat cell on an H100,
where two runs of one seed agreed within 0.5%: with a few tens of long
requests in a window, which comes when is work, and the spread has to
measure the system.

A mix is a JSON object:

* `arrivals`: `{"process": "poisson"}` (rate λ, the cell's `rate_per_s`),
  `{"process": "square_wave", "base": b, "burst": c, "period_s": p,
  "duty": d}` (λ(t) = c·rate for the first d·p seconds of every period,
  b·rate for the rest) or `{"process": "closed", "clients": n}` (n
  clients, each sending its next request when all tokens of its last
  are visible; no rate). Open-loop arrivals are the unit gaps mapped
  through the inverse of Λ(t) = ∫λ (time rescaling), which for a constant
  λ is a Poisson process and for a square wave the process that
  Lewis-Shedler thinning samples.
* `prompt_tokens`, `output_tokens`: `{"dist": "lognormal", "mean": m,
  "cv": c, "min": lo, "max": hi}` or `{"dist": "fixed", "value": v}`.
* `documents` (optional): `{"count": k, "tokens": t}`: k documents of t
  random tokens, prefilled in set-up as k requests of one new token, so
  their full blocks are indexed; each request is then one document, in
  equal shares, followed by its `prompt_tokens` (the question).

`_lognorm` is a frozen copy of `repro_torch/serving/sim.py`'s; the
exponential gaps are those of `repro_torch/serving/workload.py`'s
`poisson`, taken at their quantiles.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, List, Optional

import numpy as np

#: the streams of a seed (the run's, or the mix's schedule seed)
WINDOW, WARM, DOCS, TOKENS, SAMPLE = 1, 2, 3, 4, 5

_ND = statistics.NormalDist()


def _lognorm(mean: float, cv: float):
    """(mu, sigma) of a lognormal with this mean and coefficient of
    variation (frozen copy of `repro_torch.serving.sim._lognorm`)."""
    sigma2 = math.log(1 + cv * cv)
    mu = math.log(mean) - sigma2 / 2
    return mu, math.sqrt(sigma2)


def lengths(spec: Dict, n: int) -> List[int]:
    """n lengths: the distribution's quantiles at (i + 0.5) / n, rounded
    and clipped to [min, max], in ascending order."""
    dist = spec["dist"]
    if dist == "lognormal":
        mu, s = _lognorm(float(spec["mean"]), float(spec["cv"]))

        def at(q):
            return math.exp(mu + s * _ND.inv_cdf(q))
    elif dist == "fixed":
        def at(q):
            return float(spec["value"])
    else:
        raise ValueError(f"unknown length distribution {dist!r}")
    lo, hi = spec.get("min", 1), spec.get("max", 1 << 30)
    return [int(min(max(round(at((i + 0.5) / n)), lo), hi))
            for i in range(n)]


def unit_gaps(n: int) -> List[float]:
    """n unit-rate exponential gaps at their quantiles (i + 0.5) / n."""
    return [-math.log(1.0 - (i + 0.5) / n) for i in range(n)]


def rng(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator for one stream of the seed."""
    return np.random.default_rng([seed % (1 << 64), *stream])


class Rate:
    """λ(t) of an open loop and the inverse of its integral Λ."""

    def __init__(self, arrivals: Dict, rate: float):
        self.process = arrivals["process"]
        self.rate = float(rate)
        if self.process == "poisson":
            self.levels = [(1.0, self.rate)]
        elif self.process == "square_wave":
            p = float(arrivals["period_s"])
            d = float(arrivals["duty"])
            self.levels = [(d * p, float(arrivals["burst"]) * self.rate),
                           ((1 - d) * p, float(arrivals["base"]) * self.rate)]
        else:
            raise ValueError(f"{self.process!r} has no rate")
        self.period = sum(w for w, _ in self.levels)
        self.per_period = sum(w * lam for w, lam in self.levels)

    def integral(self, t: float) -> float:
        """Λ(t) = ∫_0^t λ."""
        k, r = divmod(t, self.period)
        out = k * self.per_period
        for w, lam in self.levels:
            out += min(max(r, 0.0), w) * lam
            r -= w
        return out

    def inverse(self, s: float) -> float:
        """The t with Λ(t) = s."""
        k, r = divmod(s, self.per_period)
        t = k * self.period
        for w, lam in self.levels:
            if r <= w * lam:
                return t + r / lam
            r -= w * lam
            t += w
        return t


@dataclasses.dataclass
class Planned:
    """One request of a run: when it is due (seconds from the window's
    start; negative in the warm phase; None in a closed loop, where its
    client sends it), how long its question and answer are, and which
    document it asks about."""
    index: int
    due: Optional[float]
    prompt_len: int
    max_new: int
    doc: Optional[int] = None
    warm: bool = False


@dataclasses.dataclass
class Plan:
    mix: Dict
    seed: int
    vocab: int
    documents: List[List[int]]
    warm: List[Planned]
    window: List[Planned]
    clients: int = 0

    def prompt(self, p: Planned) -> List[int]:
        """The request's token ids: its document, then fresh ids drawn
        from the seed's stream for this request."""
        g = rng(self.seed, TOKENS, int(p.warm), p.index)
        own = g.integers(0, self.vocab, size=p.prompt_len).tolist()
        return (list(self.documents[p.doc]) if p.doc is not None else []) \
            + own


def _requests(mix: Dict, n: int, g: np.random.Generator, warm: bool,
              dues: Optional[List[float]]) -> List[Planned]:
    ins = lengths(mix["prompt_tokens"], n)
    outs = lengths(mix["output_tokens"], n)
    g.shuffle(ins)
    g.shuffle(outs)
    docs: List[Optional[int]] = [None] * n
    if mix.get("documents"):
        k = int(mix["documents"]["count"])
        docs = [i % k for i in range(n)]
        g.shuffle(docs)
    return [Planned(i, dues[i] if dues is not None else None, ins[i],
                    outs[i], docs[i], warm) for i in range(n)]


def _dues(r: Rate, n: int, g: np.random.Generator) -> List[float]:
    gaps = unit_gaps(n)
    g.shuffle(gaps)
    s, out = 0.0, []
    for x in gaps:
        s += x
        out.append(r.inverse(s))
    return out


def plan(mix: Dict, rate: float, seed: int, seconds: float,
         warm_seconds: float, vocab: int) -> Plan:
    """The requests of one run: the warm phase's (due in
    [-warm_seconds, 0)) and the window's (due in [0, seconds)), each from
    a stream of its own, and the documents."""
    docs = []
    if mix.get("documents"):
        d = mix["documents"]
        g = rng(seed, DOCS)
        docs = [g.integers(0, vocab, size=int(d["tokens"])).tolist()
                for _ in range(int(d["count"]))]
    arr = mix["arrivals"]
    sched = int(mix.get("schedule_seed", 0))
    if arr["process"] == "closed":
        c = int(arr["clients"])
        # enough for every client to send more requests than fit a window
        n = max(64 * c, 256)
        return Plan(mix, seed, vocab, docs, [],
                    _requests(mix, n, rng(sched, WINDOW), False, None),
                    clients=c)
    r = Rate(arr, rate)
    n_win = max(1, round(r.integral(seconds)))
    n_warm = round(r.integral(warm_seconds))
    window = _requests(mix, n_win, rng(sched, WINDOW), False,
                       _dues(r, n_win, rng(sched, WINDOW, 0)))
    warm = []
    if n_warm:
        # the warm phase is the same process, ending where the window starts
        warm = _requests(mix, n_warm, rng(sched, WARM), True,
                         [t - warm_seconds for t in
                          _dues(r, n_warm, rng(sched, WARM, 0))])
    return Plan(mix, seed, vocab, docs, warm, window)
