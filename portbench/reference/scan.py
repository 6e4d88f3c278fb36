"""The selective scan in plain PyTorch, float32, in blocks: forward and backward.

``h_t = a_t * h_{t-1} + b_t`` with ``a_t = exp(dt_t A)`` and ``b_t = dt_t
x_t B_t``, ``y_t = sum_n h_t C_t``.  Time is cut into blocks of
:data:`BLOCK` steps, each block into chunks of :data:`CHUNK`; inside a
block one loop over the :data:`CHUNK` steps of a chunk advances every chunk
at once from a zero state, with the chunk's running decay, and a loop over
the chunks then carries the state across them.  No loop runs over every
step of a sequence.  :class:`Scan` is differentiable: its backward
recomputes each block's states from the state at the block's start and
runs the reverse recurrence ``g_t = dy_t C_t + a_{t+1} g_{t+1}`` the same
way.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

BLOCK = 2048
CHUNK = 32


def _linear(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """All states of ``h_t = a_t h_{t-1} + b_t`` from ``h0``: ``a``, ``b``
    ``(B, T, D, N)``, ``h0`` ``(B, D, N)``; returns ``(B, T, D, N)``."""
    bsz, t, d, n = a.shape
    c = min(CHUNK, t)
    nc = -(-t // c)
    pad = nc * c - t
    if pad:
        a = torch.cat([a, a.new_ones((bsz, pad, d, n))], 1)
        b = torch.cat([b, b.new_zeros((bsz, pad, d, n))], 1)
    a = a.view(bsz, nc, c, d, n)
    b = b.view(bsz, nc, c, d, n)
    hs = torch.empty_like(b)
    decay = torch.empty_like(a)
    h = b[:, :, 0].clone()
    p = a[:, :, 0].clone()
    hs[:, :, 0] = h
    decay[:, :, 0] = p
    for i in range(1, c):  # every chunk from a zero state at once
        h = a[:, :, i] * h + b[:, :, i]
        p = p * a[:, :, i]
        hs[:, :, i] = h
        decay[:, :, i] = p
    start = h0
    starts = []
    for j in range(nc):  # the state at each chunk's start
        starts.append(start)
        start = hs[:, j, -1] + decay[:, j, -1] * start
    hs += decay * torch.stack(starts, 1)[:, :, None]
    return hs.view(bsz, nc * c, d, n)[:, :t]


def _coeffs(dt, x, bm, a_mat, t0: int, t1: int):
    """``a`` and ``b`` of steps ``[t0, t1)``."""
    dts = dt[:, t0:t1]
    a = torch.exp(dts[..., None] * a_mat)
    b = (dts * x[:, t0:t1])[..., None] * bm[:, t0:t1, None, :]
    return a, b


def scan_forward(dt, x, bm, cm, a_mat, h0: Optional[torch.Tensor] = None, keep_starts: bool = False):
    """``(y (B, S, D), h_final (B, D, N), starts)``; ``starts`` holds the
    state at each block's start when ``keep_starts``."""
    bsz, s, d = x.shape
    h = torch.zeros((bsz, d, a_mat.shape[1]), dtype=torch.float32, device=x.device) if h0 is None else h0
    ys, starts = [], []
    for t0 in range(0, s, BLOCK):
        t1 = min(s, t0 + BLOCK)
        if keep_starts:
            starts.append(h)
        a, b = _coeffs(dt, x, bm, a_mat, t0, t1)
        hs = _linear(a, b, h)
        del a, b
        ys.append(torch.einsum("btdn,btn->btd", hs, cm[:, t0:t1]))
        h = hs[:, -1].clone()
        del hs
    return torch.cat(ys, 1), h, starts


class Scan(torch.autograd.Function):
    """``y = scan(dt, x, B, C, A)`` (the final state dropped), float32, with
    the blocked reverse recurrence as its backward."""

    @staticmethod
    def forward(ctx, dt, x, bm, cm, a_mat):
        y, _, starts = scan_forward(dt, x, bm, cm, a_mat, keep_starts=True)
        ctx.save_for_backward(dt, x, bm, cm, a_mat, *starts)
        return y

    @staticmethod
    def backward(ctx, dy):
        dt, x, bm, cm, a_mat, *starts = ctx.saved_tensors
        bsz, s, d = x.shape
        ddt, dx = torch.zeros_like(dt), torch.zeros_like(x)
        dbm, dcm = torch.zeros_like(bm), torch.zeros_like(cm)
        da = torch.zeros_like(a_mat)
        g_next = torch.zeros((bsz, d, a_mat.shape[1]), dtype=torch.float32, device=x.device)  # a_{t1} g_{t1}
        blocks = list(range(0, s, BLOCK))
        for i in reversed(range(len(blocks))):
            t0 = blocks[i]
            t1 = min(s, t0 + BLOCK)
            a, b = _coeffs(dt, x, bm, a_mat, t0, t1)
            hs = _linear(a, b, starts[i])
            h_prev = torch.cat([starts[i][:, None], hs[:, :-1]], 1)
            dcm[:, t0:t1] = torch.einsum("btdn,btd->btn", hs, dy[:, t0:t1])
            del hs, b
            q = dy[:, t0:t1, :, None] * cm[:, t0:t1, None, :]
            q[:, -1] += g_next
            # g_t = q_t + a_{t+1} g_{t+1}: the same recurrence backwards, with a shifted by one step
            a_next = torch.cat([a[:, 1:], a.new_zeros((bsz, 1) + a.shape[2:])], 1)
            g = _linear(a_next.flip(1), q.flip(1), torch.zeros_like(g_next)).flip(1)
            del a_next, q
            g_next = a[:, 0] * g[:, 0]
            dts, xs, bs = dt[:, t0:t1], x[:, t0:t1], bm[:, t0:t1]
            dadec = g * h_prev * a  # dL/d(dt A), elementwise
            del h_prev
            ddt[:, t0:t1] = torch.einsum("btdn,dn->btd", dadec, a_mat)
            da += torch.einsum("btdn,btd->dn", dadec, dts)
            del dadec
            gb = torch.einsum("btdn,btn->btd", g, bs)  # sum_n g B
            ddt[:, t0:t1] += gb * xs
            dx[:, t0:t1] = gb * dts
            dbm[:, t0:t1] = torch.einsum("btdn,btd->btn", g, dts * xs)
            del g, a
        return ddt, dx, dbm, dcm, da


def scan(dt, x, bm, cm, a_mat) -> torch.Tensor:
    """``y``; differentiable when an operand needs a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (dt, x, bm, cm, a_mat)):
        return Scan.apply(dt, x, bm, cm, a_mat)
    return scan_forward(dt, x, bm, cm, a_mat)[0]


def scan_steps(dt, x, bm, cm, a_mat) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence one step at a time: the tests' witness at tiny sizes."""
    bsz, s, d = x.shape
    h = torch.zeros((bsz, d, a_mat.shape[1]), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        h = torch.exp(dt[:, t, :, None] * a_mat) * h + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cm[:, t]))
    return torch.stack(ys, 1), h
