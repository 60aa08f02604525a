"""The plain reference of a dense GQA decoder (granite-3, mistral-nemo):
its weights made from the seed, its forward pass in fp32 with no kernel,
cache or batching, and the operation and byte counts of its step.

Plain `torch` only: nothing of the port (`repro_torch`) or of JAX.

The equations, as the port serves them (`configs/<name>.json` gives the
sizes): x = embed[tokens]; each of the L layers adds
wo·attn(rope(wq·n1(x)), rope(wk·n1(x)), wv·n1(x)) and then
w_down·(silu(w_gate·n2(x)) ⊙ w_up·n2(x)); the logits are n_f(x)·head, head
the embedding's transpose when tied. n(x) = x·rsqrt(mean(x²) + eps)·(1 + w)
(RMSNorm with its weight stored as an offset from 1). RoPE rotates the
two halves of each head (not interleaved pairs) by position·θ^(-2i/hd).
Attention is causal over absolute positions, query head h reading kv head
h // (H / KV), scores scaled by 1/sqrt(hd).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], float]

#: scale of the norm weights' offsets from 1: nonzero, so that a norm that
#: dropped its weight would show
NORM_SCALE = 0.1
#: largest normal of float8 e4m3
FP8_MAX = 448.0


def dims(c: Dict) -> Dict[str, int]:
    d, H = int(c["hidden_size"]), int(c["num_attention_heads"])
    return dict(L=int(c["num_hidden_layers"]), d=d, H=H,
                KV=int(c["num_key_value_heads"]),
                hd=int(c.get("head_dim") or d // H),
                f=int(c["intermediate_size"]), V=int(c["vocab_size"]),
                tied=bool(c["tie_word_embeddings"]))


def layout(c: Dict) -> List[Leaf]:
    """(path, shape, scale) of every weight in the port's nested layout:
    normal draws times `scale` (1/sqrt(fan_in) for a projection, 0.02 /
    sqrt(2 L) for one back into the residual stream, 0.02 for the
    embedding, NORM_SCALE for the norms' offsets), layers stacked on the
    first axis."""
    m = dims(c)
    L, d, H, KV, hd, f, V = (m[k] for k in ("L", "d", "H", "KV", "hd", "f",
                                            "V"))
    out_scale = 0.02 / math.sqrt(2 * L)
    leaves = [(("embed",), (V, d), 0.02),
              (("ln_f",), (d,), NORM_SCALE),
              (("layers", "ln1"), (L, d), NORM_SCALE),
              (("layers", "ln2"), (L, d), NORM_SCALE),
              (("layers", "attn", "wq"), (L, d, H * hd), d ** -0.5),
              (("layers", "attn", "wk"), (L, d, KV * hd), d ** -0.5),
              (("layers", "attn", "wv"), (L, d, KV * hd), d ** -0.5),
              (("layers", "attn", "wo"), (L, H * hd, d), out_scale),
              (("layers", "mlp", "w_gate"), (L, d, f), d ** -0.5),
              (("layers", "mlp", "w_up"), (L, d, f), d ** -0.5),
              (("layers", "mlp", "w_down"), (L, f, d), out_scale)]
    if not m["tied"]:
        leaves.append((("lm_head",), (d, V), d ** -0.5))
    return leaves


def make_weights(c: Dict, seed: int, device, dtype=torch.bfloat16
                 ) -> Dict:
    """Every weight drawn from `seed` on `device` in `dtype`: one buffer,
    filled by a generator on the device in calls of 2**30 draws, each leaf
    a view of it scaled in place."""
    leaves = layout(c)
    total = sum(math.prod(s) for _, s, _ in leaves)
    buf = torch.empty(total, dtype=dtype, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    step = 1 << 30
    for a in range(0, total, step):
        buf[a:a + step].normal_(0.0, 1.0, generator=g)
    tree: Dict = {}
    off = 0
    for path, shape, scale in leaves:
        n = math.prod(shape)
        leaf = buf[off:off + n].view(shape).mul_(scale)
        off += n
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


# -- counts ---------------------------------------------------------------

def layer_params(c: Dict) -> int:
    """Parameters of one layer's projections (each a multiply-add a token)."""
    m = dims(c)
    d, H, KV, hd, f = m["d"], m["H"], m["KV"], m["hd"], m["f"]
    return 2 * d * H * hd + 2 * d * KV * hd + 3 * d * f


def token_flops(c: Dict) -> int:
    """Operations of one token through every layer's projections."""
    return 2 * dims(c)["L"] * layer_params(c)


def head_flops(c: Dict) -> int:
    """Operations of one row of logits."""
    m = dims(c)
    return 2 * m["d"] * m["V"]


def attention_flops_per_key(c: Dict) -> int:
    """Operations of one query against one visible key, every layer:
    q·k and p·v for each query head."""
    m = dims(c)
    return 4 * m["H"] * m["hd"] * m["L"]


def kv_bytes_per_position(c: Dict, elt: int = 2) -> int:
    """Bytes of one position's K and V, every layer."""
    m = dims(c)
    return 2 * m["KV"] * m["hd"] * elt * m["L"]


def qo_bytes_per_query(c: Dict, elt: int = 2) -> int:
    """Bytes of one query's q read and attention output written, every
    layer."""
    m = dims(c)
    return 2 * m["H"] * m["hd"] * elt * m["L"]


def weight_bytes(c: Dict, elt: int = 2) -> int:
    """Bytes a forward reads of the weights: every layer's projections and
    norms, and the head (the embedding's rows it gathers are left out)."""
    m = dims(c)
    return elt * (m["L"] * (layer_params(c) + 2 * m["d"]) + m["d"] * m["V"]
                  + m["d"])


# -- the reference --------------------------------------------------------

class Seq:
    """A sequence the reference runs: `tokens` at positions from
    `start` on, after the sequence `parent` (an index into the list, whose
    tokens fill positions [0, start)), and the positions (within
    `tokens`) whose logits are wanted."""

    def __init__(self, tokens: Sequence[int], heads: Sequence[int] = (),
                 parent: Optional[int] = None, start: int = 0):
        self.tokens, self.heads = list(tokens), list(heads)
        self.parent, self.start = parent, start


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def _rope(x, pos, theta):
    """x (T, n, hd) fp32 rotated by positions pos (T,): halves, not pairs."""
    hd = x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                  device=x.device) / hd)
    ang = pos[:, None].double() * inv
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    a, b = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], -1)


def _fp8(x, dim):
    """x rounded to float8 e4m3 with one scale per slice along `dim` (the
    amax over it mapped to the format's largest normal), back in fp32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class _Linear:
    """x @ w in fp32, or, with `fp8`, with w per output column and x per
    row rounded to float8 e4m3 first (the W8A8 step below bf16)."""

    def __init__(self, w, fp8: bool):
        self.fp8 = fp8
        self.w = _fp8(w.float(), 0) if fp8 else w.float()

    def __call__(self, x):
        return (_fp8(x, -1) if self.fp8 else x) @ self.w


def _attend(q, k, v, qpos, kpos, block: int = 512):
    """Causal GQA attention in fp32: q (T, H, hd) at qpos, k/v (S, KV, hd)
    at kpos; queries in blocks so the scores fit."""
    T, H, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    out = torch.empty_like(q)
    kk, vv = k.permute(1, 0, 2), v.permute(1, 0, 2)          # (KV, S, hd)
    for a in range(0, T, block):
        qb = q[a:a + block].reshape(-1, KV, G, hd).permute(1, 2, 0, 3)
        s = torch.einsum("kgtd,ksd->kgts", qb, kk) / math.sqrt(hd)
        mask = kpos[None, :] <= qpos[a:a + block, None]
        s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("kgts,ksd->kgtd", p, vv)
        out[a:a + block] = o.permute(2, 0, 1, 3).reshape(-1, H, hd)
    return out


@torch.no_grad()
def logits(c: Dict, w: Dict, seqs: List[Seq], fp8: bool = False
           ) -> List[torch.Tensor]:
    """The fp32 logits (len(heads), V) of each sequence at its `heads`,
    the whole forward run layer by layer over every sequence (a parent
    before its children, whose tokens attend over its K/V). `fp8`: the
    control, every projection of every layer in W8A8 float8 (the head and
    the embedding stay exact). Matmuls run in full fp32: TF32 is switched
    off for the call."""
    m = dims(c)
    eps, theta = float(c["rms_norm_eps"]), float(c["rope_theta"])
    H, KV, hd, L = m["H"], m["KV"], m["hd"], m["L"]
    dev = w["embed"].device
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        xs = [w["embed"][torch.tensor(s.tokens, device=dev)].float()
              for s in seqs]
        pos = [torch.arange(s.start, s.start + len(s.tokens), device=dev)
               for s in seqs]
        kpos = [torch.arange(0, s.start + len(s.tokens), device=dev)
                for s in seqs]
        for i in range(L):
            lw = w["layers"]
            ln1, ln2 = lw["ln1"][i].float(), lw["ln2"][i].float()
            wq, wk, wv, wo = (_Linear(lw["attn"][k][i], fp8)
                              for k in ("wq", "wk", "wv", "wo"))
            wg, wu, wd = (_Linear(lw["mlp"][k][i], fp8)
                          for k in ("w_gate", "w_up", "w_down"))
            kv: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
            for j, s in enumerate(seqs):
                x = xs[j]
                h = _rms(x, ln1, eps)
                q = _rope(wq(h).view(-1, H, hd), pos[j], theta)
                k = _rope(wk(h).view(-1, KV, hd), pos[j], theta)
                v = wv(h).view(-1, KV, hd)
                if s.parent is not None:
                    pk, pv = kv[s.parent]
                    k, v = torch.cat([pk[:s.start], k]), \
                        torch.cat([pv[:s.start], v])
                kv[j] = (k, v)
                o = _attend(q, k, v, pos[j], kpos[j])
                x = x + wo(o.reshape(-1, H * hd))
                h = _rms(x, ln2, eps)
                xs[j] = x + wd(torch.nn.functional.silu(wg(h)) * wu(h))
            del kv
        lnf = w["ln_f"].float()
        head = w["embed"].float().T if m["tied"] else w["lm_head"].float()
        return [_rms(xs[j][s.heads], lnf, eps) @ head
                for j, s in enumerate(seqs)]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
