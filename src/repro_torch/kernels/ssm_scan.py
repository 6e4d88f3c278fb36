"""The fused selective-scan forward written by hand for Hopper (K9), with its plain version.

The counterpart of the reference's ``repro/kernels/ssm_scan.py``:

* :func:`ssm_scan` (K9, ``ssm_scan_pallas`` forward): the linear
  recurrence of a Mamba-1 block with the state on chip,
  ``csrc/ssm_scan.cu``.  It takes any ``S`` (no padding to a chunk) and
  writes the state at every chunk start when asked (``checkpoints``), as
  the reference's forward does for its backward;
* :func:`ssm_scan_ref`: the plain PyTorch version, a loop over the steps
  in float32 with the kernel's order of casts;
* :func:`fused_hbm_bytes` and :func:`xla_scan_hbm_bytes`: the reference's
  byte models.

The wrapper launches the kernel on a CUDA tensor (and counts the launch in
``ssm_scan.launches``) and raises if the launch fails; on a CPU tensor it
runs :func:`ssm_scan_ref`.  There is no fallback from one to the other.
The chunk-recompute backward (K10) comes with the training slice.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from . import _build

DTYPES = (torch.float32, torch.bfloat16)
STATES = (8, 16)  # the kernel's state widths: those of the configs with a fused scan
TILE = 32  # the kernel's steps per tile: with checkpoints, chunk is a multiple of it
# which operands are bfloat16, as csrc/ssm_scan.cu reads them
_FLAG_DT, _FLAG_X, _FLAG_BC, _FLAG_A = 1, 2, 4, 8


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
    ``ssm_scan.launches``); the kernel takes ``st`` in ``STATES``, ``D`` a
    multiple of 4 and operands that start 16-byte aligned (it reads 4
    channels at a time), and with ``checkpoints`` a ``chunk`` that is a
    multiple of ``TILE``.  A CPU tensor takes :func:`ssm_scan_ref`.
    """
    _check(dt, x, bmat, cmat, a, chunk)
    if x.device.type == "cpu":
        return ssm_scan_ref(dt, x, bmat, cmat, a, chunk=chunk, checkpoints=checkpoints)
    bsz, s, d = x.shape
    st = bmat.shape[-1]
    if st not in STATES:
        raise ValueError(f"ssm_scan: the kernel takes a state width in {STATES}, got {st}")
    if d % 4:
        raise ValueError(f"ssm_scan: the kernel takes D a multiple of 4, got {d}")
    if checkpoints and chunk % TILE:
        raise ValueError(f"ssm_scan: with checkpoints the kernel takes a chunk that is a multiple of {TILE}, got {chunk}")
    if any(t.data_ptr() % 16 for t in (dt, x, bmat, cmat, a)):
        raise ValueError("ssm_scan: the kernel takes operands that start 16-byte aligned")
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


def fused_hbm_bytes(bsz: int, s: int, d: int, st: int, elem: int = 2) -> int:
    """The reference's model of the fused kernel's device-memory traffic:
    dt, x and y (B, S, D) and B, C (B, S, st) at ``elem`` bytes, h_final
    in float32."""
    return elem * (3 * bsz * s * d + 2 * bsz * s * st) + 4 * bsz * d * st


def xla_scan_hbm_bytes(bsz: int, s: int, d: int, st: int, elem: int = 4) -> int:
    """The reference's lower bound for the associative-scan path: two
    (B, S, D, st) tensors (decay, update) read and written per scan level."""
    levels = max(1, int(math.log2(max(2, s))))
    return elem * 2 * 2 * bsz * s * d * st * levels
