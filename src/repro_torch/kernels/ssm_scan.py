"""The fused selective scan written by hand for Hopper, forward (K9) and backward (K10).

The counterpart of the reference's ``repro/kernels/ssm_scan.py``:

* :func:`ssm_scan` (K9, ``ssm_scan_pallas`` forward): the linear
  recurrence of a Mamba-1 block with the state on chip,
  ``csrc/ssm_scan.cu``.  It takes any ``S`` (no padding to a chunk) and
  writes the state at every chunk start when asked (``checkpoints``), as
  the reference's forward does for its backward.  When a gradient is
  needed it runs through :class:`SsmScanFunction`;
* :func:`ssm_scan_bwd` (K10, ``_bwd_call``): the chunk-recompute
  backward, ``csrc/ssm_scan_bwd.cu``: the five gradients from the
  forward's inputs, its checkpoints and the cotangents of ``y`` and
  ``h_final``;
* :class:`SsmScanFunction`: the ``torch.autograd.Function`` that joins
  them, the counterpart of the reference's ``custom_vjp``.  Its forward
  runs K9 with checkpoints every :data:`GRAD_CHUNK` steps, its backward
  K10;
* :func:`ssm_scan_ref` and :func:`ssm_scan_bwd_ref`: the plain PyTorch
  versions, loops over the steps in float32 with the kernels' order of
  casts;
* :func:`fused_hbm_bytes`, :func:`bwd_hbm_bytes` and
  :func:`xla_scan_hbm_bytes`: the reference's byte models.

Each wrapper launches its kernel on a CUDA tensor (and counts the launch
in ``ssm_scan.launches`` or ``ssm_scan_bwd.launches``) and raises if the
launch fails; on a CPU tensor it runs its plain version.  There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.analysis.registry import kernel_contract
from repro_torch.runtime import resilience as _res

from . import _build

DTYPES = (torch.float32, torch.bfloat16)
STATES = (8, 16)  # the kernel's state widths: those of the configs with a fused scan
TILE = 32  # the kernel's steps per tile: with checkpoints, chunk is a multiple of it
# The checkpoint interval of SsmScanFunction: K10 recomputes one 32-step tile
# from each checkpoint, its states in registers and its decays in shared
# memory (csrc/ssm_scan_bwd.cu).  It changes the memory held for the backward
# (B * ceil(S / 32) * D * st float32: 67 MB at (1, 4096, 8192, 16)) and the
# recompute, not the numbers.
GRAD_CHUNK = TILE
# which operands are bfloat16, as csrc/ssm_scan.cu reads them
_FLAG_DT, _FLAG_X, _FLAG_BC, _FLAG_A, _FLAG_DY = 1, 2, 4, 8, 16


@functools.cache
def _symbol():
    lib = _build.load("ssm_scan")
    fn = lib.ssm_scan_fwd
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [P, P, P, P, P, P, P, P, I64, I64, I, I, I64, I, P]
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib


def _check(dt, x, bmat, cmat, a, chunk: int) -> None:
    ops = {"dt": dt, "x": x, "bmat": bmat, "cmat": cmat, "a": a}
    for name, t in ops.items():
        if t.dtype not in DTYPES:
            raise TypeError(f"ssm_scan: {name} must be float32 or bfloat16, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"ssm_scan: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan: {name} must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssm_scan: unsupported device {x.device}")
    if x.ndim != 3 or dt.shape != x.shape:
        raise ValueError(f"ssm_scan: dt and x must be one (B, S, D) shape, got {tuple(dt.shape)} and {tuple(x.shape)}")
    bsz, s, d = x.shape
    if bmat.ndim != 3 or bmat.shape[:2] != (bsz, s) or cmat.shape != bmat.shape:
        raise ValueError(f"ssm_scan: bmat and cmat must be (B, S, st) = ({bsz}, {s}, st), "
                         f"got {tuple(bmat.shape)} and {tuple(cmat.shape)}")
    if bmat.dtype != cmat.dtype:
        raise TypeError(f"ssm_scan: bmat and cmat must share a dtype, got {bmat.dtype} and {cmat.dtype}")
    if tuple(a.shape) != (d, bmat.shape[2]):
        raise ValueError(f"ssm_scan: a must be (D, st) = ({d}, {bmat.shape[2]}), got {tuple(a.shape)}")
    if min(bsz, s, d, bmat.shape[2]) < 1:
        raise ValueError(f"ssm_scan: empty operands {tuple(x.shape)}, st {bmat.shape[2]}")
    if chunk < 1:
        raise ValueError(f"ssm_scan: chunk must be at least 1, got {chunk}")


def ssm_scan_ref(
    dt: torch.Tensor,
    x: torch.Tensor,
    bmat: torch.Tensor,
    cmat: torch.Tensor,
    a: torch.Tensor,
    *,
    chunk: int = 256,
    checkpoints: bool = False,
):
    """Plain version of K9: the direct recurrence, one step at a time.

    Every operand is cast to float32 first, and ``dt * x`` is formed from
    the float32 casts, as the kernel does (the reference's oracle forms it
    in the input dtype, which differs only when both are bfloat16).
    Returns ``(y, h_final)``, or ``(y, h_final, hstart)`` with
    ``checkpoints``: the state at the start of every chunk.
    """
    bsz, s, d = x.shape
    st = bmat.shape[-1]
    dt32, b32, c32, a32 = dt.float(), bmat.float(), cmat.float(), a.float()
    dx = dt32 * x.float()
    h = torch.zeros((bsz, d, st), dtype=torch.float32, device=x.device)
    y = torch.empty((bsz, s, d), dtype=torch.float32, device=x.device)
    hstart = torch.empty((bsz, -(-s // chunk), d, st), dtype=torch.float32, device=x.device) if checkpoints else None
    for t in range(s):
        if checkpoints and t % chunk == 0:
            hstart[:, t // chunk] = h
        decay = torch.exp(dt32[:, t, :, None] * a32)
        h = decay * h + dx[:, t, :, None] * b32[:, t, None, :]
        y[:, t] = (h * c32[:, t, None, :]).sum(-1)
    y = y.to(x.dtype)
    return (y, h, hstart) if checkpoints else (y, h)


@kernel_contract(kind="scan", batched=True, differentiable=True)
def ssm_scan(
    dt: torch.Tensor,  # (B, S, D), float32 or bfloat16
    x: torch.Tensor,  # (B, S, D)
    bmat: torch.Tensor,  # (B, S, st)
    cmat: torch.Tensor,  # (B, S, st), bmat's dtype
    a: torch.Tensor,  # (D, st)
    *,
    chunk: int = 256,
    checkpoints: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Fused selective scan (K9): ``(y (B, S, D) in x's dtype, h_final (B, D, st) float32)``.

    With ``checkpoints`` it also returns ``hstart (B, ceil(S / chunk), D,
    st)`` float32, the state at the start of every chunk (the first is 0).
    ``S`` need not be a multiple of ``chunk``.  Operands are contiguous,
    float32 or bfloat16 each (``bmat`` and ``cmat`` one dtype), on one
    device.

    A CUDA tensor launches the kernel (and counts one in
    ``ssm_scan.launches``) on the operands :func:`check_kernel_rules`
    passes, and raises on others.  A CPU tensor takes :func:`ssm_scan_ref`.

    When grad mode is on and an operand requires a gradient, the call goes
    through :class:`SsmScanFunction`: K9 with checkpoints every
    :data:`GRAD_CHUNK` steps (``chunk`` is then unused), and K10 in the
    backward.  Asking for ``checkpoints`` then raises: the Function keeps
    its own, and the checkpoints returned would carry no gradient.
    Otherwise the call is guarded as the reference's ``ssm_scan_pallas``
    is (that op name, no verifier): a failed launch raises
    ``GuardedDispatchError``.  The guard does not wrap the Function, as
    the reference's steps aside under its autodiff.
    """
    _check(dt, x, bmat, cmat, a, chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (dt, x, bmat, cmat, a)):
        if checkpoints:
            raise ValueError("ssm_scan: checkpoints=True carries no gradient; call it without checkpoints "
                             "(the gradient's own are kept every GRAD_CHUNK steps) or under torch.no_grad()")
        return SsmScanFunction.apply(dt, x, bmat, cmat, a)
    if x.is_cuda:  # operands the kernel refuses are the caller's error, raised before the guard
        check_kernel_rules(dt, x, bmat, cmat, a, chunk, checkpoints)
    if not _res.guard_enabled() or _res.is_tracing():
        return _forward(dt, x, bmat, cmat, a, chunk, checkpoints)
    bsz, s, d = x.shape
    meta = {"n": s, "batch": bsz, "dtype": str(x.dtype).removeprefix("torch."), "seq": s, "d_model": d,
            "state": bmat.shape[-1], "chunk": chunk}
    return _res.guarded_call("ssm_scan_pallas",
                             [(_res.attempt_label(x), lambda: _forward(dt, x, bmat, cmat, a, chunk, checkpoints))],
                             meta=meta)


def check_kernel_rules(dt, x, bmat, cmat, a, chunk: int, checkpoints: bool, dy=None) -> None:
    """Raise ``ValueError`` unless K9 takes these operands (already through
    :func:`_check`): a state width in ``STATES``; ``D`` times the element
    size of ``dt`` and of ``x`` (and of ``dy``, K10's cotangent, when given)
    a multiple of 16 bytes, and every operand 16-byte aligned (the kernels
    read them through TMA tensor maps, whose rows and bases must be); with
    ``checkpoints``, a ``chunk`` that is a multiple of ``TILE``.  K10 takes
    what it passes too (:func:`check_bwd_kernel_rules`), so both kernels
    refuse the same operands.  Plain Python on the shapes, dtypes and
    addresses, so it runs on a CPU tensor too."""
    st, d = bmat.shape[-1], x.shape[-1]
    if st not in STATES:
        raise ValueError(f"ssm_scan: the kernel takes a state width in {STATES}, got {st}")
    rows = (("dt", dt), ("x", x)) + ((("dy", dy),) if dy is not None else ())
    for name, t in rows:
        if d * t.element_size() % 16:
            raise ValueError(f"ssm_scan: the kernel takes D times the element size of {name} a multiple of 16 "
                             f"bytes, got D = {d} in {t.dtype}")
    if checkpoints and chunk % TILE:
        raise ValueError(f"ssm_scan: with checkpoints the kernel takes a chunk that is a multiple of {TILE}, got {chunk}")
    if any(t.data_ptr() % 16 for t in (bmat, cmat, a) + tuple(t for _, t in rows)):
        raise ValueError("ssm_scan: the kernel takes operands that start 16-byte aligned")


def _forward(dt, x, bmat, cmat, a, chunk: int, checkpoints: bool):
    """One K9 launch on a CUDA tensor, :func:`ssm_scan_ref` on a CPU one."""
    if x.device.type == "cpu":
        return ssm_scan_ref(dt, x, bmat, cmat, a, chunk=chunk, checkpoints=checkpoints)
    check_kernel_rules(dt, x, bmat, cmat, a, chunk, checkpoints)
    bsz, s, d = x.shape
    st = bmat.shape[-1]
    y = torch.empty((bsz, s, d), dtype=x.dtype, device=x.device)
    h_final = torch.empty((bsz, d, st), dtype=torch.float32, device=x.device)
    hstart = (torch.empty((bsz, -(-s // chunk), d, st), dtype=torch.float32, device=x.device)
              if checkpoints else None)
    bf16 = torch.bfloat16
    flags = ((_FLAG_DT if dt.dtype == bf16 else 0) | (_FLAG_X if x.dtype == bf16 else 0)
             | (_FLAG_BC if bmat.dtype == bf16 else 0) | (_FLAG_A if a.dtype == bf16 else 0))
    fn, lib = _symbol()
    with torch.cuda.device(x.device):
        err = fn(dt.data_ptr(), x.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), a.data_ptr(), y.data_ptr(),
                 h_final.data_ptr(), hstart.data_ptr() if checkpoints else None, bsz, s, d, st, chunk, flags,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssm_scan launch failed: {lib.repro_cuda_error_string(err).decode()} (cudaError {err})")
    ssm_scan.launches += 1
    return (y, h_final, hstart) if checkpoints else (y, h_final)


ssm_scan.launches = 0


@functools.cache
def _bwd_symbol():
    lib = _build.load("ssm_scan_bwd")
    fn = lib.ssm_scan_bwd
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [P] * 14 + [I64, I64, I64, I, I, I, P]
    fn.restype = ctypes.c_int
    lib.ssm_scan_bwd_work_floats.argtypes = [I64, I64, I, I]
    lib.ssm_scan_bwd_work_floats.restype = I64
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib


def bwd_work_floats(bsz: int, s: int, d: int, st: int) -> int:
    """Float32 of the workspace one K10 call takes (asks the built kernel):
    its partials of dB and dC, one per block of 64 channels, and the ``B``
    partials of dA."""
    return int(_bwd_symbol()[1].ssm_scan_bwd_work_floats(bsz, s, d, st))


def _check_bwd(dt, x, bmat, cmat, a, hstart, dy, dh_final, chunk: int) -> None:
    _check(dt, x, bmat, cmat, a, chunk)
    bsz, s, d = x.shape
    st = bmat.shape[2]
    want = {"hstart": (hstart, (bsz, -(-s // chunk), d, st)), "dh_final": (dh_final, (bsz, d, st))}
    for name, (t, shape) in want.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"ssm_scan_bwd: {name} must be float32 {shape}, got {t.dtype} {tuple(t.shape)}")
    if dy.dtype not in DTYPES or dy.shape != x.shape:
        raise ValueError(f"ssm_scan_bwd: dy must be float32 or bfloat16 {tuple(x.shape)}, got {dy.dtype} {tuple(dy.shape)}")
    for name, t in (("hstart", hstart), ("dy", dy), ("dh_final", dh_final)):
        if t.device != x.device:
            raise ValueError(f"ssm_scan_bwd: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan_bwd: {name} must be contiguous")


def check_bwd_kernel_rules(dt, x, bmat, cmat, a, hstart, dy, dh_final, chunk: int) -> None:
    """Raise ``ValueError`` unless K10 takes these operands (already through
    :func:`_check_bwd`): what :func:`check_kernel_rules` asks of K9's, with
    ``dy``'s rows too; the checkpoints of ``chunk == TILE``, one per 32-step
    tile, as K9 writes them for :class:`SsmScanFunction`; ``hstart``, ``dy``
    and ``dh_final`` 16-byte aligned.  Plain Python, so it runs on a CPU
    tensor too."""
    check_kernel_rules(dt, x, bmat, cmat, a, chunk, True, dy=dy)
    if chunk != TILE:
        raise ValueError(f"ssm_scan_bwd: the kernel takes the checkpoints of chunk {TILE}, got {chunk}")
    if any(t.data_ptr() % 16 for t in (hstart, dh_final)):
        raise ValueError("ssm_scan: the kernel takes operands that start 16-byte aligned")


def ssm_scan_bwd_ref(dt, x, bmat, cmat, a, hstart, dy, dh_final, *, chunk: int):
    """Plain version of K10: ``(ddt, dx, dB, dC, dA)`` in float32.

    Per chunk, last to first: the chunk's states recomputed from its
    checkpoint ``hstart[:, c]`` as :func:`ssm_scan_ref` runs them, then
    the reverse recurrence of the reference's ``_bwd_kernel`` one step at
    a time, with ``g = dL/dh`` carried from ``dh_final`` backwards.
    """
    bsz, s, d = x.shape
    dt32, x32, b32, c32, a32, dy32 = (t.float() for t in (dt, x, bmat, cmat, a, dy))
    dtx = dt32 * x32
    dev = x.device
    ddt = torch.empty((bsz, s, d), dtype=torch.float32, device=dev)
    dx = torch.empty_like(ddt)
    db = torch.empty(tuple(bmat.shape), dtype=torch.float32, device=dev)
    dc = torch.empty_like(db)
    da = torch.zeros(tuple(a.shape), dtype=torch.float32, device=dev)
    g = dh_final.float().clone()
    for c in reversed(range(-(-s // chunk))):
        t0, t1 = c * chunk, min(s, (c + 1) * chunk)
        hs = [hstart[:, c]]
        for t in range(t0, t1):
            decay = torch.exp(dt32[:, t, :, None] * a32)
            hs.append(decay * hs[-1] + dtx[:, t, :, None] * b32[:, t, None, :])
        for t in reversed(range(t0, t1)):
            h_prev, h_t = hs[t - t0], hs[t - t0 + 1]
            dy_t = dy32[:, t, :, None]
            dc[:, t] = (h_t * dy_t).sum(1)
            g = g + dy_t * c32[:, t, None, :]
            decay = torch.exp(dt32[:, t, :, None] * a32)
            gdec = g * h_prev * decay  # dL/d(dt_t a), through exp
            s_gb = (g * b32[:, t, None, :]).sum(-1)  # dL/d(dt_t x_t)
            ddt[:, t] = (gdec * a32).sum(-1) + x32[:, t] * s_gb
            dx[:, t] = dt32[:, t] * s_gb
            db[:, t] = (g * dtx[:, t, :, None]).sum(1)
            da += (dt32[:, t, :, None] * gdec).sum(0)
            g = g * decay
    return ddt, dx, db, dc, da


def ssm_scan_bwd(
    dt: torch.Tensor,  # (B, S, D), the forward's operands
    x: torch.Tensor,
    bmat: torch.Tensor,  # (B, S, st)
    cmat: torch.Tensor,
    a: torch.Tensor,  # (D, st)
    hstart: torch.Tensor,  # (B, ceil(S / chunk), D, st) float32: the forward's checkpoints
    dy: torch.Tensor,  # (B, S, D), float32 or bfloat16: the cotangent of y
    dh_final: torch.Tensor,  # (B, D, st) float32: the cotangent of h_final
    *,
    chunk: int,
) -> Tuple[torch.Tensor, ...]:
    """Chunk-recompute backward (K10): ``(ddt, dx (B, S, D), dB, dC (B, S,
    st), dA (D, st))``, all float32, as the reference's ``_bwd_call``.

    A CUDA tensor launches the kernel (and counts one in
    ``ssm_scan_bwd.launches``) on the operands
    :func:`check_bwd_kernel_rules` passes, and raises on others.  Two
    launches on the same operands give the same bits (no atomics).  A CPU
    tensor takes :func:`ssm_scan_bwd_ref`.
    """
    _check_bwd(dt, x, bmat, cmat, a, hstart, dy, dh_final, chunk)
    if x.device.type == "cpu":
        return ssm_scan_bwd_ref(dt, x, bmat, cmat, a, hstart, dy, dh_final, chunk=chunk)
    check_bwd_kernel_rules(dt, x, bmat, cmat, a, hstart, dy, dh_final, chunk)
    bsz, s, d = x.shape
    st = bmat.shape[-1]
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    ddt, dx = torch.empty((bsz, s, d), **f32), torch.empty((bsz, s, d), **f32)
    db, dc = torch.empty((bsz, s, st), **f32), torch.empty((bsz, s, st), **f32)
    da = torch.empty((d, st), **f32)
    fn, lib = _bwd_symbol()
    n_work = bwd_work_floats(bsz, s, d, st)
    work = torch.empty((n_work,), **f32)
    bf16 = torch.bfloat16
    flags = ((_FLAG_DT if dt.dtype == bf16 else 0) | (_FLAG_X if x.dtype == bf16 else 0)
             | (_FLAG_BC if bmat.dtype == bf16 else 0) | (_FLAG_A if a.dtype == bf16 else 0)
             | (_FLAG_DY if dy.dtype == bf16 else 0))
    ptrs = [t.data_ptr() for t in (dt, x, bmat, cmat, a, hstart, dy, dh_final, ddt, dx, db, dc, da, work)]
    with torch.cuda.device(dev):
        err = fn(*ptrs, n_work, bsz, s, d, st, flags, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"ssm_scan_bwd launch failed: {lib.repro_cuda_error_string(err).decode()} (cudaError {err})")
    ssm_scan_bwd.launches += 1
    return ddt, dx, db, dc, da


ssm_scan_bwd.launches = 0


class SsmScanFunction(torch.autograd.Function):
    """``(y, h_final) = ssm_scan(dt, x, bmat, cmat, a)`` with K10 as its
    backward: the counterpart of the reference's ``custom_vjp``.

    The forward runs K9 with checkpoints every :data:`GRAD_CHUNK` steps and
    keeps them with the operands; the backward runs K10 and casts each
    gradient to its operand's dtype, as ``_ssm_scan_bwd`` does.  An unused
    output's cotangent arrives as zeros.
    """

    @staticmethod
    def forward(ctx, dt, x, bmat, cmat, a):
        y, h_final, hstart = _forward(dt, x, bmat, cmat, a, GRAD_CHUNK, True)
        ctx.save_for_backward(dt, x, bmat, cmat, a, hstart)
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        return _backward(ctx.saved_tensors, dy, dh_final)


def _backward(saved, dy, dh_final):
    """:class:`SsmScanFunction`'s backward on its saved ``(dt, x, bmat, cmat,
    a, hstart)``: K10, each gradient cast to its operand's dtype."""
    dt, x, bmat, cmat, a, hstart = saved
    grads = ssm_scan_bwd(dt, x, bmat, cmat, a, hstart, dy.contiguous(), dh_final.float().contiguous(),
                         chunk=GRAD_CHUNK)
    return tuple(gr.to(op.dtype) for gr, op in zip(grads, (dt, x, bmat, cmat, a)))


def smem_bytes(st: int, dt_bf16: bool, x_bf16: bool) -> int:
    """The dynamic shared memory of one K9 block (``Layout<ST, kDtB,
    kXB>::kBytes`` of csrc/ssm_scan.cu), 0 for a state width the kernel
    refuses: 128 bytes of barriers; a ring of 4 stages of a 32-step tile
    (dt and x of 32 channels, B and C as bfloat16 bits and as float32);
    3 buffers of the consumer warps' float32 parts of y; 4 y tiles in x's
    dtype.  It does not depend on B, C or a being bfloat16."""
    if st not in STATES:
        return 0
    steps, ch, warps = TILE, 32, st // 4
    dt_b, x_b = steps * ch * (2 if dt_bf16 else 4), steps * ch * (2 if x_bf16 else 4)
    stage = dt_b + x_b + 2 * steps * st * 2 + 2 * steps * st * 4
    return 128 + 4 * stage + 3 * 4 * steps * warps * ch + 4 * x_b


def bwd_smem_bytes(st: int, dt_bf16: bool, x_bf16: bool, dy_bf16: bool, bc_bf16: bool) -> int:
    """The dynamic shared memory of one K10 block (``Layout<ST, kDtB, kXB,
    kDyB, kBcB>::kBytes`` of csrc/ssm_scan_bwd.cu), 0 for a state width the
    kernel refuses: 128 bytes of barriers; a ring of 2 stages of a 32-step
    tile of 64 channels (dt, x, dy, B, C and the float32 checkpoint); the
    float2 slots of decays and parts; two tiles of dB and dC per half; each
    warp's B and C as float32.  The reduction after it requests none."""
    if st not in STATES:
        return 0
    steps, ch, warps = TILE, 64, st

    def size(bf16: bool) -> int:
        return 2 if bf16 else 4

    stage = steps * ch * (size(dt_bf16) + size(x_bf16) + size(dy_bf16)) + 2 * steps * st * size(bc_bf16) + ch * st * 4
    return 128 + 2 * stage + steps * warps * 32 * 8 + 2 * 2 * 2 * steps * st * 4 + warps * steps * 16


def fused_hbm_bytes(bsz: int, s: int, d: int, st: int, elem: int = 2) -> int:
    """The reference's model of the fused kernel's device-memory traffic:
    dt, x and y (B, S, D) and B, C (B, S, st) at ``elem`` bytes, h_final
    in float32."""
    return elem * (3 * bsz * s * d + 2 * bsz * s * st) + 4 * bsz * d * st


def bwd_hbm_bytes(bsz: int, s: int, d: int, st: int, chunk: int, elem: int = 2) -> int:
    """The reference's model of the recompute backward's device-memory
    traffic: the forward's inputs and dy at ``elem`` bytes, the float32
    checkpoints in, the five float32 gradients out."""
    fwd_in = elem * (3 * bsz * s * d + 2 * bsz * s * st)
    ckpt = 4 * bsz * (s // max(1, chunk)) * d * st
    grads_out = 4 * (2 * bsz * s * d + 2 * bsz * s * st + d * st)
    return fwd_in + ckpt + grads_out


def xla_scan_hbm_bytes(bsz: int, s: int, d: int, st: int, elem: int = 4) -> int:
    """The reference's lower bound for the associative-scan path: two
    (B, S, D, st) tensors (decay, update) read and written per scan level."""
    levels = max(1, int(math.log2(max(2, s))))
    return elem * 2 * 2 * bsz * s * d * st * levels
