"""The comparison that decides `correct`: the tokens the timed path served
against the plain reference.

After the window, a sample of the finished requests (drawn from the seed,
the one with the most served tokens always in it) is run through the
configuration's plain reference in fp32, whole prompt and served tokens,
layer by layer. The number compared is the widest gap by which a served
token's logit lies below the reference's best logit at its position:
greedy serving of the same weights and inputs gives 0 up to the rounding
of the served precision. The control (`control=True`, never in the
benchmark's own runs) puts the tokens that the reference in float8 (W8A8)
puts first in the served tokens' place, and is judged by the same limit.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from perfbench import traffic


def sample(served: Sequence[Tuple[int, List[int], List[int]]], seed: int,
           n: int) -> List[Tuple[int, List[int], List[int]]]:
    """n of the (index, prompt, tokens) finished requests: the one with
    the most tokens, then others drawn from the seed."""
    if not served:
        return []
    pool = sorted(served, key=lambda s: s[0])
    longest = max(pool, key=lambda s: (len(s[2]), -s[0]))
    rest = [s for s in pool if s is not longest]
    g = traffic.rng(seed, traffic.SAMPLE)
    pick = g.permutation(len(rest))[:max(0, n - 1)]
    return [longest] + [rest[i] for i in sorted(pick)]


def _doc(prompt: List[int], documents: List[List[int]]):
    """The document `prompt` opens with, or None."""
    return next((j for j, d in enumerate(documents)
                 if len(prompt) > len(d) and prompt[:len(d)] == d), None)


def sequences(fam, picked, documents: List[List[int]]):
    """The reference's sequences: each document asked about once, then
    each request after it (its question and served tokens), or each
    request alone; with the positions whose logits predict its served
    tokens."""
    seqs, parent, out = [], {}, []
    docs = [_doc(prompt, documents) for _, prompt, _ in picked]
    for doc in docs:
        if doc is not None and doc not in parent:
            parent[doc] = len(seqs)
            seqs.append(fam.Seq(documents[doc]))
    for doc, (_, prompt, toks) in zip(docs, picked):
        start = len(documents[doc]) if doc is not None else 0
        head = len(prompt) - 1 - start
        out.append(len(seqs))
        seqs.append(fam.Seq(prompt[start:] + toks[:-1],
                            range(head, head + len(toks)),
                            parent.get(doc), start))
    return seqs, out


def gaps(fam, config: Dict, weights, picked, documents,
         control: bool = False):
    """For every served token of `picked`, the reference's best logit at
    its position minus the logit of the served token; with `control`, also
    the same gap of the token the float8 reference puts first there (the
    control in the program's place). Returns (served gaps, control gaps or
    None)."""
    import torch

    seqs, idx = sequences(fam, picked, documents)
    ref = fam.logits(config, weights, seqs)
    low = fam.logits(config, weights, seqs, fp8=True) if control else None
    served: List[float] = []
    ctl: List[float] = []
    for k, (_, _, toks) in zip(idx, picked):
        lg = ref[k]
        best = lg.max(-1).values
        chosen = torch.tensor(toks, device=lg.device)
        served.extend((best - lg.gather(-1, chosen[:, None])[:, 0]).tolist())
        if control:
            first = low[k].argmax(-1)
            ctl.extend((best - lg.gather(-1, first[:, None])[:, 0]).tolist())
    return served, (ctl if control else None)


def verdict(widest: float, limit: float) -> Dict[str, Dict[str, float]]:
    """The number compared beside its limit."""
    return {"widest_gap": {"value": widest, "limit": limit}}
