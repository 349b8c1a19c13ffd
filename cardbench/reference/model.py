"""Plain float32 reference of the decoder that the benchmark's
configurations describe: Qwen2 (dense, QKV bias, rotary positions,
SwiGLU) and Qwen2-MoE (top-k routed experts at a capacity, shared experts
behind a sigmoid gate).

Written from the published architecture in plain PyTorch: no kernel, no
cache, no batching trick, and nothing imported from the program under
test.  It takes the configuration's JSON (``cardbench/configs``) and
parameters by name in the ``[in, out]`` layout that :func:`param_blocks`
lays out.  Departures from the published models that the configuration
states (``reduced`` / ``assumed``) are followed here too: the router's
softmax over the chosen k, the capacity rule, the padded vocabulary (its
extra logits enter the loss's log-sum-exp), and the RMS gain stored as
``1 + g``.

``mm`` is the one matrix product that every projection and both of
attention's products go through, so that a control can run the same
model in a lower precision
(:mod:`cardbench.reference.precision`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def plain_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


@dataclasses.dataclass(frozen=True)
class Arch:
    d: int
    layers: int
    heads: int
    kv_heads: int
    ff: int
    vocab: int
    padded_vocab: int
    theta: float
    eps: float
    experts: int = 0
    topk: int = 0
    moe_ff: int = 0
    shared_ff: int = 0
    capacity_factor: float = 1.25

    @property
    def hd(self) -> int:
        return self.d // self.heads


def arch_from_config(cfg: dict) -> Arch:
    """The reference's sizes from a configuration file's keys."""
    assumed = cfg.get("assumed", {})
    return Arch(
        d=cfg["hidden_size"], layers=cfg["num_hidden_layers"],
        heads=cfg["num_attention_heads"],
        kv_heads=cfg["num_key_value_heads"], ff=cfg["intermediate_size"],
        vocab=cfg["vocab_size"],
        padded_vocab=assumed.get("padded_vocab", cfg["vocab_size"]),
        theta=float(cfg["rope_theta"]), eps=float(cfg["rms_norm_eps"]),
        experts=cfg.get("num_experts", 0),
        topk=cfg.get("num_experts_per_tok", 0),
        moe_ff=cfg.get("moe_intermediate_size", 0),
        shared_ff=cfg.get("shared_expert_intermediate_size", 0),
        capacity_factor=float(assumed.get("capacity_factor", 1.25)))


def param_blocks(a: Arch) -> List[Tuple[str, Dict[str, Tuple[int, ...]]]]:
    """Every parameter's name and shape, grouped in blocks (the embedding
    and head first, then one block a layer): the order in which
    :mod:`cardbench.weights` draws them."""
    d, hd = a.d, a.hd
    blocks = [("top", {"embed": (a.padded_vocab, d), "final_ln": (d,),
                       "unembed": (d, a.padded_vocab)})]
    for i in range(a.layers):
        p = f"layers.{i}."
        s = {p + "ln": (d,), p + "wq": (d, a.heads * hd),
             p + "wk": (d, a.kv_heads * hd), p + "wv": (d, a.kv_heads * hd),
             p + "wo": (a.heads * hd, d), p + "bq": (a.heads * hd,),
             p + "bk": (a.kv_heads * hd,), p + "bv": (a.kv_heads * hd,),
             p + "fln": (d,)}
        if a.experts:
            E, f, fs = a.experts, a.moe_ff, a.shared_ff
            s.update({p + "router": (d, E), p + "we_gate": (E, d, f),
                      p + "we_up": (E, d, f), p + "we_down": (E, f, d),
                      p + "ws_gate": (d, fs), p + "ws_up": (d, fs),
                      p + "ws_down": (fs, d), p + "ws_sig": (d, 1)})
        else:
            s.update({p + "w_gate": (d, a.ff), p + "w_up": (d, a.ff),
                      p + "w_down": (a.ff, d)})
        blocks.append((f"layer{i}", s))
    return blocks


def rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1 + g)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, heads, hd] at positions 0..S-1; the rotation pairs the two
    halves of each head."""
    S, _, hd = x.shape
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64,
                                    device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] \
        * freqs
    c = torch.cos(ang).to(x.dtype)[:, None]
    s = torch.sin(ang).to(x.dtype)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def causal_attention(q, k, v, mm: Matmul = plain_mm,
                     head_chunk: int = 8) -> torch.Tensor:
    """Softmax attention of one sequence: q [S, H, hd], k / v [S, KVH, hd]
    (each KV head serves H / KVH query heads), causal, scale hd^-1/2;
    heads taken ``head_chunk`` at a time to bound the [S, S] scores."""
    S, H, hd = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    allowed = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    outs = []
    for h0 in range(0, H, head_chunk):
        sl = slice(h0, h0 + head_chunk)
        qh, kh, vh = (t[:, sl].transpose(0, 1) for t in (q, k, v))
        s = mm(qh, kh.transpose(1, 2)) * hd ** -0.5
        p = torch.softmax(s.masked_fill(~allowed, float("-inf")), dim=-1)
        outs.append(mm(p, vh).transpose(0, 1))
    return torch.cat(outs, dim=1)


def capacity(tokens: int, topk: int, experts: int, cf: float) -> int:
    """Slots an expert holds: ``min(ceil8(int(tokens * k / E * cf)),
    tokens)`` (the configuration's ``capacity_rule``)."""
    c = max(int(tokens * topk / experts * cf), 1)
    return min(-(-c // 8) * 8, tokens)


def swiglu(x, wg, wu, wd, mm: Matmul) -> torch.Tensor:
    return mm(F.silu(mm(x, wg)) * mm(x, wu), wd)


def moe(h: torch.Tensor, p: Dict[str, torch.Tensor], pre: str, a: Arch,
        mm: Matmul) -> torch.Tensor:
    """h [T, d] → routed experts plus the gated shared experts.  Each
    token picks its top-k experts by router logit and weighs them by the
    softmax of those k logits; an expert takes its first ``capacity``
    assignments in token order and drops the rest."""
    T = h.shape[0]
    E, k = a.experts, a.topk
    logits = mm(h, p[pre + "router"])
    top_v, top_i = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(top_v, dim=-1)
    C = capacity(T, k, E, a.capacity_factor)
    flat_e = top_i.reshape(-1)
    flat_t = torch.arange(T, device=h.device).repeat_interleave(k)
    order = torch.argsort(flat_e * T + flat_t)
    e_s, t_s = flat_e[order], flat_t[order]
    g_s = gates.reshape(-1)[order]
    counts = torch.bincount(e_s, minlength=E).tolist()
    y = torch.zeros_like(h)
    lo = 0
    for e in range(E):
        hi = lo + min(counts[e], C)
        t = t_s[lo:hi]
        out = swiglu(h[t], p[pre + "we_gate"][e], p[pre + "we_up"][e],
                     p[pre + "we_down"][e], mm)
        y = y.index_add(0, t, out * g_s[lo:hi, None])
        lo += counts[e]
    shared = swiglu(h, p[pre + "ws_gate"], p[pre + "ws_up"],
                    p[pre + "ws_down"], mm)
    return y + shared * torch.sigmoid(mm(h, p[pre + "ws_sig"]))


def layer(p: Dict[str, torch.Tensor], i: int, x: torch.Tensor, a: Arch,
          mm: Matmul = plain_mm) -> torch.Tensor:
    """Layer ``i`` on one sequence x [S, d]."""
    pre = f"layers.{i}."
    S = x.shape[0]
    h = rms(x, p[pre + "ln"], a.eps)
    q = (mm(h, p[pre + "wq"]) + p[pre + "bq"]).view(S, a.heads, a.hd)
    k = (mm(h, p[pre + "wk"]) + p[pre + "bk"]).view(S, a.kv_heads, a.hd)
    v = (mm(h, p[pre + "wv"]) + p[pre + "bv"]).view(S, a.kv_heads, a.hd)
    o = causal_attention(rope(q, a.theta), rope(k, a.theta), v, mm)
    x = x + mm(o.reshape(S, a.heads * a.hd), p[pre + "wo"])
    h = rms(x, p[pre + "fln"], a.eps)
    if a.experts:
        return x + moe(h, p, pre, a, mm)
    return x + swiglu(h, p[pre + "w_gate"], p[pre + "w_up"],
                      p[pre + "w_down"], mm)


def head_logits(p, x: torch.Tensor, a: Arch,
                mm: Matmul = plain_mm) -> torch.Tensor:
    """Logits over the padded vocabulary of hidden states x [..., d]."""
    return mm(rms(x, p["final_ln"], a.eps), p["unembed"])


def batch_layer(p, i: int, x: torch.Tensor, a: Arch,
                mm: Matmul = plain_mm) -> torch.Tensor:
    """Layer ``i`` on x [B, S, d]: attention a row at a time, the experts
    (whose capacity counts every token of the batch) over all rows."""
    if not a.experts:
        return torch.stack([layer(p, i, r, a, mm) for r in x])
    pre = f"layers.{i}."
    B, S, d = x.shape
    rows = []
    for r in x:
        h = rms(r, p[pre + "ln"], a.eps)
        q = (mm(h, p[pre + "wq"]) + p[pre + "bq"]).view(S, a.heads, a.hd)
        k = (mm(h, p[pre + "wk"]) + p[pre + "bk"]).view(S, a.kv_heads, a.hd)
        v = (mm(h, p[pre + "wv"]) + p[pre + "bv"]).view(S, a.kv_heads, a.hd)
        o = causal_attention(rope(q, a.theta), rope(k, a.theta), v, mm)
        rows.append(r + mm(o.reshape(S, a.heads * a.hd), p[pre + "wo"]))
    x = torch.stack(rows)
    h = rms(x, p[pre + "fln"], a.eps).reshape(B * S, d)
    return x + moe(h, p, pre, a, mm).reshape(B, S, d)


def loss(p, tokens: torch.Tensor, labels: torch.Tensor, a: Arch,
         mm: Matmul = plain_mm, remat: bool = True,
         rows_per_chunk: int = 1024) -> torch.Tensor:
    """Mean next-token cross-entropy of tokens [B, S] against labels
    [B, S] over the labels below ``vocab``; the log-sum-exp spans the
    padded vocabulary.  With ``remat`` each layer and each chunk of the
    head is recomputed in the backward, so that float32 activations of a
    whole batch fit."""
    from torch.utils.checkpoint import checkpoint
    x = p["embed"][tokens]
    for i in range(a.layers):
        if remat:
            x = checkpoint(batch_layer, p, i, x, a, mm, use_reentrant=False)
        else:
            x = batch_layer(p, i, x, a, mm)
    xf = x.reshape(-1, a.d)
    lab = labels.reshape(-1)
    keep = (lab >= 0) & (lab < a.vocab)

    def chunk_nll(xc, lc, kc):
        lg = head_logits(p, xc, a, mm)
        ll = lg.gather(1, torch.where(kc, lc, 0)[:, None])[:, 0]
        return torch.where(kc, torch.logsumexp(lg, dim=-1) - ll, 0.0).sum()

    total = xf.new_zeros(())
    for s in range(0, xf.shape[0], rows_per_chunk):
        sl = slice(s, s + rows_per_chunk)
        if remat:
            total = total + checkpoint(chunk_nll, xf[sl], lab[sl], keep[sl],
                                       use_reentrant=False)
        else:
            total = total + chunk_nll(xf[sl], lab[sl], keep[sl])
    return total / keep.sum().clamp_min(1)
