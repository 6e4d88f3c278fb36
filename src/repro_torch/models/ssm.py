"""Mamba-1 selective SSM block (falcon-mamba).

The PyTorch counterpart of the reference's ``repro/models/ssm.py``.  The
scan runs, per ``cfg.ssm_backend``:

* ``"scan"`` — a chunked scan in plain PyTorch: the (decay, update) pairs
  are materialised as ``(B, S, d_inner, state)`` tensors, scanned inside
  each chunk in log-depth (Hillis-Steele over the linear-recurrence monoid
  ``(a2, b2) o (a1, b1) = (a1 * a2, b1 * a2 + b2)``) and carried from chunk
  to chunk in a loop, as the reference's associative scan does;
* ``"fused"`` — the hand-written selective-scan kernels
  (:func:`repro_torch.kernels.ssm_scan.ssm_scan`): the state stays on chip
  and the decay/update tensors are never materialised.  It trains: when a
  gradient is needed the forward (K9) keeps chunk checkpoints and the
  backward is the chunk-recompute kernel (K10), through
  :class:`~repro_torch.kernels.ssm_scan.SsmScanFunction`.

Parameters keep the reference's layout; :func:`mamba_init` stacks them on
the leading axes ``lead`` (the layers).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.parallel.sharding import constrain

from .layers import dense_init

_SCAN_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def mamba_init(gen: torch.Generator, cfg: ModelConfig, dtype, lead=()) -> Dict:
    """One block's parameters, stacked on ``lead``; ``A_log`` and ``D`` are float32."""
    d, di, st, r, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
    lead = tuple(lead)
    dev = gen.device
    a = torch.arange(1, st + 1, dtype=torch.float32, device=dev)[None, :].expand(*lead, di, st)
    return {
        "in_proj": dense_init(gen, lead + (d, 2 * di), d, dtype),
        "conv_w": dense_init(gen, lead + (di, k), k, dtype),
        "x_proj": dense_init(gen, lead + (di, r + 2 * st), di, dtype),
        "dt_proj": dense_init(gen, lead + (r, di), r, dtype),
        "dt_bias": torch.zeros(lead + (di,), dtype=dtype, device=dev),
        "A_log": torch.log(a).contiguous(),  # float32: exp of it is sensitive
        "D": torch.ones(lead + (di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, lead + (di, d), di, dtype),
    }


def _ssm_scan_chunked(decay: torch.Tensor, upd: torch.Tensor, h0: torch.Tensor, chunk: int):
    """Linear recurrence ``h_t = decay_t * h_{t-1} + upd_t``, chunked.

    ``decay``/``upd`` ``(B, S, di, st)``, ``h0 (B, di, st)``.  Returns
    ``(ys (B, S, di, st), h_final)``.
    """
    b, s, di, st = decay.shape
    chunk = min(chunk, s)
    nchunks = -(-s // chunk)
    pad = nchunks * chunk - s
    if pad:  # identity steps: decay 1, update 0; h_final is preserved
        decay = torch.cat([decay, decay.new_ones((b, pad, di, st))], 1)
        upd = torch.cat([upd, upd.new_zeros((b, pad, di, st))], 1)
    a_cum = decay.reshape(b, nchunks, chunk, di, st)
    b_cum = upd.reshape(b, nchunks, chunk, di, st)
    off = 1
    while off < chunk:  # inclusive scan inside every chunk at once
        a_prev, b_prev = a_cum[:, :, :-off], b_cum[:, :, :-off]
        a_cur, b_cur = a_cum[:, :, off:], b_cum[:, :, off:]
        a_cum = torch.cat([a_cum[:, :, :off], a_prev * a_cur], 2)
        b_cum = torch.cat([b_cum[:, :, :off], b_prev * a_cur + b_cur], 2)
        off *= 2
    h = h0
    ys = []
    for c in range(nchunks):
        y_c = a_cum[:, c] * h[:, None] + b_cum[:, c]
        ys.append(y_c)
        h = y_c[:, -1]
    return torch.cat(ys, 1)[:, :s], h


def ssm_apply(
    dt: torch.Tensor,  # (B, S, di) float32, post-softplus step sizes
    xc: torch.Tensor,  # (B, S, di) conv + silu activations
    bmat: torch.Tensor,  # (B, S, st)
    cmat: torch.Tensor,  # (B, S, st)
    a: torch.Tensor,  # (di, st), negative
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective-scan core: ``(y (B, S, di) float32 = sum_s h * C,
    h_final (B, di, st) float32)``.

    ``"fused"`` launches K9 on a CUDA tensor (its plain version on a CPU
    one; differentiable through K10) and casts its ``y``, which is in
    ``xc``'s dtype, to float32, as the reference does; ``"scan"`` materialises the decay/update pairs in
    ``cfg.ssm_scan_dtype`` and runs the chunked scan.
    """
    b, s, di = xc.shape
    st = bmat.shape[-1]
    if cfg.ssm_backend == "fused":
        y, h_final = ssm_scan(dt, xc, bmat.contiguous(), cmat.contiguous(), a, chunk=cfg.ssm_chunk)
        return y.float(), h_final
    sdt = _SCAN_DTYPES[cfg.ssm_scan_dtype]
    decay = torch.exp(dt[..., None] * a[None, None]).to(sdt)
    upd = ((dt[..., None] * bmat.float()[:, :, None, :]) * xc.float()[..., None]).to(sdt)
    h0 = torch.zeros((b, di, st), dtype=sdt, device=xc.device)
    hs, h_final = _ssm_scan_chunked(decay, upd, h0, cfg.ssm_chunk)
    y = torch.sum(hs.float() * cmat.float()[:, :, None, :], dim=-1)
    return y, h_final.float()


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor]):
    """Depthwise causal conv: ``x (B, S, di)``, ``w (di, k)``, ``state
    (B, k-1, di)`` or None.  Returns ``(out (B, S, di), new_state)``."""
    k = w.shape[1]
    if state is None:
        xpad = F.pad(x, (0, 0, k - 1, 0))
    else:
        xpad = torch.cat([state.to(x.dtype), x], 1)
    out = torch.zeros_like(x)  # windowed sum: out_t = sum_i w[:, i] * xpad[:, t + i]
    for i in range(k):
        out = out + xpad[:, i : i + x.shape[1]] * w[None, None, :, i]
    new_state = xpad[:, -(k - 1):] if k > 1 else None
    return out, new_state


def _project(params: Dict, xc: torch.Tensor, cfg: ModelConfig):
    """``xc -> (dt float32, B, C)`` and ``a = -exp(A_log)``."""
    r, st = cfg.dt_rank, cfg.ssm_state
    proj = xc @ params["x_proj"]
    dt_r, bmat, cmat = torch.split(proj, [r, st, st], dim=-1)
    dt = F.softplus(dt_r @ params["dt_proj"] + params["dt_bias"]).float()
    return dt, bmat, cmat, -torch.exp(params["A_log"])


def mamba_block(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The block over a whole sequence: ``(out (B, S, d), xin (B, S, di),
    h_final (B, di, st) float32)``, ``xin`` being the conv's input, from
    which a caller that decodes on takes its conv state."""
    xz = constrain(x @ params["in_proj"], "act_batch", "act_seq", "act_ff")
    xin, z = torch.chunk(xz, 2, dim=-1)
    xc, _ = _causal_conv(xin, params["conv_w"], None)
    xc = F.silu(xc)
    dt, bmat, cmat, a = _project(params, xc, cfg)
    y, h_final = ssm_apply(dt, xc, bmat, cmat, a, cfg)
    y = (y + params["D"][None, None] * xc.float()).to(x.dtype)
    y = constrain(y * F.silu(z), "act_batch", "act_seq", "act_ff")
    return y @ params["out_proj"], xin, h_final


def mamba_forward(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Training/prefill form: ``x (B, S, d) -> (B, S, d)``."""
    return mamba_block(params, x, cfg)[0]


def mamba_decode(
    params: Dict,
    x: torch.Tensor,  # (B, 1, d)
    conv_state: torch.Tensor,  # (B, k-1, di)
    ssm_state: torch.Tensor,  # (B, di, st) float32
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """O(1) decode step: ``(out (B, 1, d), conv_state', ssm_state')``.

    The states passed in are not changed; the caller stores the new ones.
    """
    xin, z = torch.chunk(x @ params["in_proj"], 2, dim=-1)  # (B, 1, di)
    xc, new_conv = _causal_conv(xin, params["conv_w"], conv_state)
    xc = F.silu(xc)[:, 0]  # (B, di)
    dt, bmat, cmat, a = _project(params, xc, cfg)
    decay = torch.exp(dt[..., None] * a[None])  # (B, di, st)
    upd = (dt[..., None] * bmat.float()[:, None, :]) * xc.float()[..., None]
    h = decay * ssm_state + upd
    y = torch.sum(h * cmat.float()[:, None, :], dim=-1)  # (B, di)
    y = (y + params["D"][None] * xc.float()).to(x.dtype)
    y = (y * F.silu(z[:, 0]))[:, None]  # (B, 1, di)
    return y @ params["out_proj"], new_conv, h


def mamba_init_cache(cfg: ModelConfig, batch: int, dtype, device) -> Dict:
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32, device=device),
    }
