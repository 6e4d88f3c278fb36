"""The plain reference of the benchmark's models, in float32.

It follows the configuration as the program runs it (the configuration
file's ``as_run`` and ``departures``): phi3.5-moe's decoder layer (RMS
norm, grouped-query causal attention with rotary positions, a softmax
top-2 router over 16 experts with the capacity rule, SwiGLU experts) and
falcon-mamba's Mamba-1 block (in_proj, a causal depthwise conv, the
selective scan of :mod:`.scan`, the gate, out_proj), the embedding scaled
by ``sqrt(d)`` and the tied head.  It imports nothing of the program and
no JAX; it reads only the configuration and the weights the benchmark
made.  Matrix products run in float32 with TF32 off (:func:`exact`);
``quant="fp8"`` rounds both operands of every product to float8 e4m3 with
a scale a tensor first (and their gradients to e5m2): the control, one
precision below the configuration's bfloat16; ``quant="bf16"`` rounds them
to bfloat16, the configuration's own precision.

Weights are converted to float32 a layer at a time, and attention runs in
blocks of query rows, so that the reference fits beside the weights.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .scan import scan, scan_forward

Q_BLOCK = 1024  # query rows of attention at a time
FP8_MAX = 448.0
E5M2_MAX = 57344.0


def exact() -> None:
    """Float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).float() * scale


class _Q8(torch.autograd.Function):
    """Float8 as training in it runs: the operand in e4m3, its gradient in
    e5m2, each under one scale for the tensor."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def q8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the tensor, back in
    float32 (a gradient through it rounded to e5m2)."""
    return _Q8.apply(t)


def mm(a: torch.Tensor, b: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    if quant == "fp8":
        a, b = q8(a), q8(b)
    elif quant == "bf16":
        a, b = a.bfloat16().float(), b.bfloat16().float()
    return a @ b


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + w.float())


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """``x (S, heads, hd)`` rotated by position, the halves form."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = pos.float()[:, None] * freqs
    s, c = torch.sin(ang)[:, None], torch.cos(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)


def _layer(params: Dict, name: str, i: int) -> Dict:
    node = params["layers"][name]
    return {k: v[i] for k, v in node.items()} if isinstance(node, dict) else node[i]


def attention(cfg: Dict, p: Dict, h: torch.Tensor, quant: Optional[str], keep: Optional[Dict] = None) -> torch.Tensor:
    """Causal grouped-query attention over one sequence ``h (S, d)``; ``keep``
    gets the rotated keys and the values ``(S, kv, hd)``."""
    s = h.shape[0]
    nh, kv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    g = nh // kv
    pos = torch.arange(s, device=h.device)
    q = rope(mm(h, p["wq"].float(), quant).view(s, nh, hd), pos, cfg["rope_theta"]).view(s, kv, g, hd)
    k = rope(mm(h, p["wk"].float(), quant).view(s, kv, hd), pos, cfg["rope_theta"])
    v = mm(h, p["wv"].float(), quant).view(s, kv, hd)
    if keep is not None:
        keep.update(k=k, v=v)
    kt = k.permute(1, 2, 0)  # (kv, hd, S)
    vt = v.permute(1, 0, 2)  # (kv, S, hd)
    out = torch.empty((s, kv, g, hd), dtype=torch.float32, device=h.device)
    for q0 in range(0, s, Q_BLOCK):
        q1 = min(s, q0 + Q_BLOCK)
        qb = q[q0:q1].permute(1, 2, 0, 3).reshape(kv, g * (q1 - q0), hd)
        sc = mm(qb, kt[:, :, :q1], quant).view(kv, g, q1 - q0, q1) / math.sqrt(hd)
        mask = torch.arange(q1, device=h.device)[None, :] <= torch.arange(q0, q1, device=h.device)[:, None]
        sc = torch.where(mask, sc, float("-inf"))
        pr = torch.softmax(sc, dim=-1).view(kv, g * (q1 - q0), q1)
        out[q0:q1] = mm(pr, vt[:, :q1], quant).view(kv, g, q1 - q0, hd).permute(2, 0, 1, 3)
    return mm(out.reshape(s, nh * hd), p["wo"].float(), quant)


def capacity(cfg: Dict, tokens: int) -> int:
    k, e = cfg["num_experts_per_tok"], cfg["num_local_experts"]
    c = int(math.ceil(tokens * k * cfg["as_run"]["capacity_factor"] / e))
    return max(8, -(-c // 8) * 8)


def moe(cfg: Dict, p: Dict, h: torch.Tensor, quant: Optional[str], cap: Optional[int] = None,
        keep: Optional[Dict] = None) -> torch.Tensor:
    """The routed experts over one sequence ``h (S, d)``: softmax top-k
    (the lower expert first among equal scores), weights renormalised;
    slots numbered ``token * k + j``; an expert keeps its first ``cap``
    slots (``capacity`` of the sequence by default) in that order and drops
    the rest.  ``keep`` gets the slots each expert was given."""
    s = h.shape[0]
    e, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(mm(h, p["router"].float(), quant), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    flat = top_e.reshape(-1)
    onehot = F.one_hot(flat, e)
    if keep is not None:
        keep["counts"] = onehot.sum(0)
    pos = (torch.cumsum(onehot, 0) - 1).gather(1, flat[:, None])[:, 0]
    kept = pos < (capacity(cfg, s) if cap is None else cap)
    weight = top_p.reshape(-1) * kept
    tok = torch.arange(s, device=h.device).repeat_interleave(k)
    y = torch.zeros_like(h)
    for ex in range(e):
        sel = torch.nonzero((flat == ex) & kept)[:, 0]
        if sel.numel() == 0:
            continue
        y.index_add_(0, tok[sel], _expert(p, ex, h[tok[sel]], quant) * weight[sel, None])
    return y


def _expert(p: Dict, ex: int, x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    act = F.silu(mm(x, p["wg"][ex].float(), quant)) * mm(x, p["wi"][ex].float(), quant)
    return mm(act, p["wo"][ex].float(), quant)


def mamba(cfg: Dict, p: Dict, h: torch.Tensor, quant: Optional[str], keep: Optional[Dict] = None) -> torch.Tensor:
    """The Mamba-1 block over ``h (B, S, d)``; ``keep`` gets the scan's final state ``ssm (B, d_inner, state)``."""
    di, st, r = cfg["intermediate_size"], cfg["state_size"], cfg["time_step_rank"]
    xin, z = torch.chunk(mm(h, p["in_proj"].float(), quant), 2, dim=-1)
    kc = cfg["conv_kernel"]
    w = p["conv_w"].float()
    xpad = F.pad(xin, (0, 0, kc - 1, 0))
    xc = sum(xpad[:, i:i + xin.shape[1]] * w[:, i] for i in range(kc))
    xc = F.silu(xc)
    dt_r, bm, cm = torch.split(mm(xc, p["x_proj"].float(), quant), [r, st, st], dim=-1)
    dt = F.softplus(mm(dt_r, p["dt_proj"].float(), quant) + p["dt_bias"].float())
    a_mat = -torch.exp(p["A_log"].float())
    if keep is None:
        y = scan(dt, xc, bm.contiguous(), cm.contiguous(), a_mat)
    else:
        y, keep["ssm"], _ = scan_forward(dt, xc, bm.contiguous(), cm.contiguous(), a_mat)
    y = y + p["D"].float() * xc
    return mm(y * F.silu(z), p["out_proj"].float(), quant)


def embed(cfg: Dict, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"]["table"][tokens].float() * math.sqrt(cfg["hidden_size"])


def layer(cfg: Dict, params: Dict, i: int, x: torch.Tensor, quant: Optional[str],
          keep: Optional[Dict] = None) -> torch.Tensor:
    """Layer ``i`` on ``x``: ``(S, d)`` for the MoE model, ``(B, S, d)`` for
    Mamba; ``keep`` gets what a prefill's cache holds of the layer."""
    eps = cfg["as_run"]["rms_eps"]
    h = rms(x, params["layers"]["attn_norm"][i], eps)
    if cfg["family"] == "moe":
        x = x + attention(cfg, _layer(params, "attn", i), h, quant, keep)
        return x + moe(cfg, _layer(params, "moe", i), rms(x, params["layers"]["ffn_norm"][i], eps), quant)
    return x + mamba(cfg, _layer(params, "mamba", i), h, quant, keep)


def head(cfg: Dict, params: Dict, x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    x = rms(x, params["final_norm"], cfg["as_run"]["rms_eps"])
    return mm(x, params["embed"]["table"].float().T, quant)


EachLayer = Optional[Callable[[int, Dict], None]]


@torch.no_grad()
def hidden(cfg: Dict, params: Dict, tokens: torch.Tensor, quant: Optional[str] = None,
           each_layer: EachLayer = None) -> torch.Tensor:
    """The last layer's output ``(S, d)`` over the prompt ``tokens (S,)``;
    ``each_layer(i, keep)`` gets layer ``i``'s keys and values ``k``, ``v``
    ``(S, kv, hd)`` (MoE) or final scan state ``ssm`` (Mamba)."""
    x = embed(cfg, params, tokens)
    if cfg["family"] == "ssm":
        x = x[None]
    for i in range(cfg["num_hidden_layers"]):
        keep = {} if each_layer else None
        x = layer(cfg, params, i, x, quant, keep)
        if each_layer:
            each_layer(i, keep)
    return x.reshape(-1, x.shape[-1])


@torch.no_grad()
def last_logits(cfg: Dict, params: Dict, tokens: torch.Tensor, quant: Optional[str] = None,
                each_layer: EachLayer = None) -> torch.Tensor:
    """The logits ``(V,)`` at the last position of the prompt ``tokens (S,)``."""
    return head(cfg, params, hidden(cfg, params, tokens, quant, each_layer)[-1:], quant)[0]


TIE_BAND = 0.1  # router logits (about unit spread) closer than this may be ordered either way by rounding
MAX_VARIANTS = 64


def _last_token_layer(cfg: Dict, p_att: Dict, p_moe: Dict, norms, x: torch.Tensor, keys, values, counts,
                      cap: int, quant: Optional[str]) -> List[torch.Tensor]:
    """One layer for the last token ``x (d,)`` at position ``S - 1``, over
    the earlier tokens' ``keys`` and ``values``: its outputs under every
    routing that rounding could give it (the k-th and the next expert
    swapped where their router logits lie within :data:`TIE_BAND`; a slot
    kept and dropped where its expert's earlier slots lie within one of
    ``cap``)."""
    eps = cfg["as_run"]["rms_eps"]
    nh, kv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    s = keys.shape[0] + 1
    pos = torch.tensor([s - 1], device=x.device)
    h = rms(x[None], norms[0], eps)
    q = rope(mm(h, p_att["wq"].float(), quant).view(1, nh, hd), pos, cfg["rope_theta"]).view(kv, nh // kv, hd)
    k = torch.cat([keys, rope(mm(h, p_att["wk"].float(), quant).view(1, kv, hd), pos, cfg["rope_theta"])])
    v = torch.cat([values, mm(h, p_att["wv"].float(), quant).view(1, kv, hd)])
    sc = mm(q, k.permute(1, 2, 0), quant) / math.sqrt(hd)  # (kv, g, S)
    out = mm(torch.softmax(sc, dim=-1), v.permute(1, 0, 2), quant)  # (kv, g, hd)
    x = x + mm(out.reshape(1, nh * hd), p_att["wo"].float(), quant)[0]
    hf = rms(x[None], norms[1], eps)
    kk = cfg["num_experts_per_tok"]
    logits = mm(hf, p_moe["router"].float(), quant)[0]
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, descending=True, stable=True).indices.tolist()
    choices = [order[:kk]]
    if float(logits[order[kk - 1]] - logits[order[kk]]) < TIE_BAND:
        choices.append(order[:kk - 1] + [order[kk]])
    outs = []
    for experts in choices:
        w = probs[experts] / probs[experts].sum()
        ys = [_expert(p_moe, ex, hf, quant)[0] * w[j] for j, ex in enumerate(experts)]
        kept = [[True] if int(counts[ex]) < cap - 1 else [False] if int(counts[ex]) > cap else [True, False]
                for ex in experts]
        combos = [[]]
        for j, opts in enumerate(kept):
            combos = [c + [o] for c in combos for o in opts]
        for combo in combos:
            y = torch.zeros_like(x)
            for j, on in enumerate(combo):  # slot order, as the combine sums them
                if on:
                    y = y + ys[j]
            outs.append(x + y)
    return outs


@torch.no_grad()
def last_logits_variants(cfg: Dict, params: Dict, tokens: torch.Tensor, quant: Optional[str] = None,
                         each_layer: EachLayer = None) -> torch.Tensor:
    """The MoE model's logits at the last position, ``(n, V)``: the first
    row as :func:`last_logits` gives it, the others under the routings of
    the last token that a near tie could give it (:func:`_last_token_layer`;
    at most :data:`MAX_VARIANTS`).  A program that rounds differently may
    route a token at a near tie either way; the last token's own routing
    is what moves its logits most, and only it is branched.  ``each_layer``
    gets each layer's keys and values of every position but the last."""
    s = tokens.shape[0]
    cap = capacity(cfg, s)
    eps = cfg["as_run"]["rms_eps"]
    x = embed(cfg, params, tokens)
    pre, last = x[:-1], [x[-1]]
    for i in range(cfg["num_hidden_layers"]):
        p_att, p_moe = _layer(params, "attn", i), _layer(params, "moe", i)
        norms = (params["layers"]["attn_norm"][i], params["layers"]["ffn_norm"][i])
        kv: Dict = {}
        pre = pre + attention(cfg, p_att, rms(pre, norms[0], eps), quant, keep=kv)
        pre = pre + moe(cfg, p_moe, rms(pre, norms[1], eps), quant, cap=cap, keep=kv)
        if each_layer:
            each_layer(i, kv)
        last = [y for xl in last for y in _last_token_layer(cfg, p_att, p_moe, norms, xl, kv["k"], kv["v"],
                                                             kv["counts"], cap, quant)][:MAX_VARIANTS]
    return head(cfg, params, torch.stack(last), quant)


def train_logits(cfg: Dict, params: Dict, tokens: torch.Tensor, quant: Optional[str] = None) -> torch.Tensor:
    """Logits ``(B, S, V)`` of a Mamba batch, every layer recomputed in the backward."""
    x = embed(cfg, params, tokens)
    for i in range(cfg["num_hidden_layers"]):
        x = checkpoint(layer, cfg, params, i, x, quant, use_reentrant=False)
    return head(cfg, params, x, quant)
