"""The kernel checker: every contract proven on the parameter lattice.

The port's counterpart of the reference's ``repro/analysis/checker.py``.
For every contract in :mod:`repro_torch.analysis.registry` it proves these
rules, each on the port's own objects:

* **A000 registry completeness**: every public callable of
  ``repro_torch.kernels.ops``, and ``ssm_scan``, carries a contract.
* **A001 shape contract**: the real wrapper, run on small tensors drawn
  from a seeded ``torch.Generator`` (sorted for the merges) on ``device``,
  gives exactly the output shapes and dtypes the contract's model says.
  On the CPU the wrappers take their plain versions and nothing is
  launched; on a CUDA device every point launches its kernels.  (The
  reference traces with ``jax.eval_shape``; the port's wrappers refuse
  meta tensors, so they run.)  On a CUDA device a scan point the kernel
  refuses (:func:`repro_torch.kernels.ssm_scan.check_kernel_rules`) must
  raise ``ValueError``.
* **A002 block divisibility**: a closed-form model of the port's launches
  (:func:`kernel_launches`): each merge's blocks of fixed spans cover its
  outputs exactly; the sort rounds have power-of-two widths with ``tile |
  2 * width`` and data a multiple of ``2 * width`` and of the tile; the
  tile sort's blocks hold whole chunks; and a sort given a tile that is
  not a power of two must *reject* it (``ValueError``), not run it.
* **A003 window reads**: :func:`launch_reads` models every block of a
  launch as its source runs it: the warp co-rank searches read inside
  Algorithm 2's interval (``lo = max(0, d - |B|)``, ``hi = min(d, |A|)``)
  at the block's first and last diagonal; the staged windows follow from
  any co-ranks in those intervals through the kernel's clamp of ``wa``;
  each window is read as the 16-byte vectors of its aligned cover (at the
  worst alignment, ``16 / size - 1`` elements past each end), clipped to
  the length the kernel is given (a merge row's, the flat sort buffer's
  ``m + tile``); a round's extra block writes the ``tile`` sentinels; and
  the shared-memory merge reads one slot past each side inside the
  block's buffer.  Every read must land inside the buffers the wrapper
  allocates: each operand of a merge (its rows read in place at their
  strides) and the flat ``m + tile`` buffer of a sort.
* **A004 sentinel policy**: a contract that carries values or ragged
  lengths must exclude pads by index; an unmasked keys-only contract must
  say why sentinel-tied keys still merge exactly.
* **A005 shared-memory budget**: the dynamic shared memory each launch
  requests (:func:`smem_bytes`: ``kernels.merge_path.smem_bytes`` for the
  merge-path kernels, the layouts of ``kernels.ssm_scan`` for K9 and K10)
  fits the per-block budget (:data:`SMEM_BUDGET_BYTES`).
* **A006 gradient shapes**: for a differentiable contract,
  ``torch.autograd.grad`` of the float outputs' sum gives every cotangent
  its primal's shape and dtype.

Every check is an ordinary function taking explicit parameters, so the
tests aim them at known-bad inputs (a padding removed, a budget too small)
and assert that they fire.  :func:`launch_model_calls` holds
:func:`kernel_launches` against the wrappers the ops really call
(:func:`observe_wrappers`), on the CPU in the tests and on the card in
``chip_smoke.py``, which also holds :func:`smem_bytes` against what each
source's ``<kernel>_smem_bytes`` says its launch requests.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch._device import resolve_device

from .lattice import LatticeConfig, model_lattice, scan_lattice, trace_lattice
from .registry import KernelContract, registered_contracts

# The dynamic shared memory one block may request on Hopper (sm_90): 227 KB.
SMEM_BUDGET_BYTES: Dict[str, int] = {"h100": 232448}
# The model counts a launch's exact request (the C sources size it from the
# same spans and layouts), not an estimate of a working set, so the whole
# budget is usable: no headroom is needed.
SMEM_USABLE_FRACTION = 1.0

VALUE_DTYPE = "float32"  # the payload dtype of the sweeps

_DTYPES = {"float32": torch.float32, "int32": torch.int32, "bfloat16": torch.bfloat16, "int16": torch.int16}
# the sorts' int keys: floats compare through their total-order keys
_SORT_KEY = {"float32": "int32", "bfloat16": "int16", "int32": "int32", "int16": "int16"}
_INT32_MAX = 2**31 - 1


@dataclass(frozen=True)
class Violation:
    """One contract violation found by the checker."""

    rule: str  # "A000".."A006"
    kernel: str
    config: str
    message: str

    def __str__(self) -> str:
        return f"[{self.rule}] {self.kernel} ({self.config}): {self.message}"


def _dt(name: str) -> torch.dtype:
    return _DTYPES[name]


def _esize(name: str) -> int:
    return _dt(name).itemsize


def _is_float(name: str) -> bool:
    return _dt(name).is_floating_point


def _split(n: int) -> Tuple[int, int]:
    """Uneven |A|, |B| split (na != nb exercises the clamped diagonals)."""
    na = max(1, (2 * n) // 3)
    return na, n - na


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, (max(1, n) - 1).bit_length())


def _is_pow2(n: int) -> bool:
    return n >= 1 and n & (n - 1) == 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# The launch model: which kernels a contract's op launches at a point
# ---------------------------------------------------------------------------


class Launch(NamedTuple):
    """One kernel launch of an op, as the model predicts it.

    ``kernel`` is the wrapper's name (``merge``, ..., ``sort_tiles_kv``,
    ``ssm_scan``, ``ssm_scan_bwd``), ``key`` its key dtype's name (the
    scan's: x's), ``dims`` its geometry:

    * ``merge``/``merge_kv``: ``(na, nb)``;
    * the row merges K5-K8: ``(rows, na, nb)``;
    * ``sort_round``/``sort_round_kv``: ``(m, width, tile)``, ``m`` the
      flat data length;
    * ``sort_tiles``/``sort_tiles_kv``: ``(n, chunk)``;
    * ``ssm_scan``: ``(B, S, D, st, chunk)``, ``chunk`` 0 without
      checkpoints; ``ssm_scan_bwd``: ``(B, S, D, st)``.

    ``layout`` places a row merge's operands in the buffers they are read
    from, in elements: ``(a_offset, a_stride, a_buffer, b_offset,
    b_stride, b_buffer)`` (empty for the other kernels)."""

    kernel: str
    key: str
    dims: Tuple[int, ...]
    layout: Tuple[int, ...] = ()


_ROW_KERNELS = ("merge_batched", "merge_kv_batched", "merge_batched_ragged", "merge_kv_batched_ragged")


def _scan_refused(cfg: LatticeConfig) -> bool:
    """Whether K9 and K10 refuse this point's operands: ``check_kernel_rules``
    on one step of them (the rules read shapes, dtypes and alignment, and
    fresh tensors are aligned)."""
    from repro_torch.kernels import ssm_scan as sc

    x = torch.empty((1, 1, cfg.d_model), dtype=_dt(cfg.dtype))
    bc = torch.empty((1, 1, cfg.state), dtype=_dt(cfg.dtype))
    try:
        sc.check_kernel_rules(x, x, bc, bc, torch.empty((cfg.d_model, cfg.state), dtype=_dt(cfg.dtype)), cfg.chunk,
                              False)
    except ValueError:
        return True
    return False


def kernel_launches(contract: KernelContract, cfg: LatticeConfig, grad: bool = False) -> List[Launch]:
    """The kernels one call of the op of ``contract`` launches at ``cfg`` on
    a CUDA device, in order, as :mod:`repro_torch.kernels.ops` dispatches
    it: a closed-form model the card's check holds against the real calls.
    With ``grad``, those of a call whose inputs require a gradient and of
    its backward (they differ for the selective scan only)."""
    from repro_torch.kernels import merge_path as mp
    from repro_torch.kernels import ssm_scan as sc

    name, tile, dt = contract.name, cfg.tile, cfg.dtype
    if contract.kind == "scan":
        if _scan_refused(cfg):
            return []
        b, s, d, st = cfg.batch, cfg.seq, cfg.d_model, cfg.state
        if grad and contract.differentiable:  # the gradient's forward keeps checkpoints
            return [Launch("ssm_scan", dt, (b, s, d, st, sc.GRAD_CHUNK)), Launch("ssm_scan_bwd", dt, (b, s, d, st))]
        return [Launch("ssm_scan", dt, (b, s, d, st, 0))]
    if contract.kind == "merge":
        na, nb = _split(cfg.n)
        if cfg.n <= tile:  # the core rank merge
            return []
        if not contract.batched:
            return [Launch(name, dt, (na, nb))]
        rows = cfg.batch
        return [Launch(name, dt, (rows, na, nb), (0, na, rows * na, 0, nb, rows * nb))]
    if contract.kind == "merge_k":
        runs, n_run = cfg.runs, max(1, cfg.n // cfg.runs)
        rows, w, out = _pow2_ceil(runs), n_run, []
        if runs == 1:
            return out
        while rows > 1:  # A and B: the even and odd rows of the (rows, w) buffer, read in place
            pairs = rows // 2
            if 2 * w > tile:
                out.append(Launch("merge_batched_ragged", dt, (pairs, w, w), (0, 2 * w, rows * w, w, 2 * w, rows * w)))
            rows, w = pairs, 2 * w
        return out
    # the sorts and the top-k
    if contract.pow2_tile and not _is_pow2(tile):
        return []  # rejected before anything runs
    n = cfg.n
    if n <= 1:
        return []
    values = contract.carries_values or contract.kind == "topk" or _is_float(dt)
    key = _SORT_KEY[dt]
    rows = cfg.batch if contract.batched else 1
    m = rows * _pow2_ceil(n)
    width = min(_pow2_ceil(n), tile)
    chunk = min(width, mp.MAX_TILE)
    out = []
    if chunk > 1:
        out.append(Launch("sort_tiles_kv" if values else "sort_tiles", key, (m, chunk)))
    while width < _pow2_ceil(n):
        out.append(Launch("sort_round_kv" if values else "sort_round", key, (m, width, tile)))
        width *= 2
    return out


def launch_smem(launch: Launch) -> int:
    """The dynamic shared memory one launch requests (bytes)."""
    from repro_torch.kernels import merge_path as mp
    from repro_torch.kernels import ssm_scan as sc

    k, kb = launch.kernel, _esize(launch.key)
    if k in ("merge", "merge_kv"):
        return mp.smem_bytes("merge", kb, k == "merge_kv")
    if k in _ROW_KERNELS:
        return mp.smem_bytes("rows", kb, "kv" in k)
    if k in ("sort_round", "sort_round_kv"):
        values = k == "sort_round_kv"
        m, width, _ = launch.dims
        return mp.smem_bytes("round", kb, values, span=mp.round_span(m, width, values))
    if k in ("sort_tiles", "sort_tiles_kv"):
        return mp.smem_bytes("tiles", kb, k == "sort_tiles_kv", chunk=launch.dims[1])
    bf = launch.key == "bfloat16"
    if k == "ssm_scan":
        return sc.smem_bytes(launch.dims[3], bf, bf)
    if k == "ssm_scan_bwd":
        return sc.bwd_smem_bytes(launch.dims[3], bf, bf, bf, bf)
    raise KeyError(f"no shared-memory model for kernel {k!r}")


def smem_bytes(contract: KernelContract, cfg: LatticeConfig) -> int:
    """The largest dynamic shared memory any launch of the contract's op
    (and of its gradient) requests at ``cfg`` (0 when it launches nothing)."""
    launches = kernel_launches(contract, cfg) + kernel_launches(contract, cfg, grad=True)
    return max((launch_smem(launch) for launch in launches), default=0)


# ---------------------------------------------------------------------------
# Call builders: contract name -> (callable, args, expected outputs,
# differentiable argnums).  The checker's model of each entry point's
# signature; A001 compares it with what the wrapper returns.
# ---------------------------------------------------------------------------


def _keys(shape, dtype: str, gen: torch.Generator, sort: bool = False) -> torch.Tensor:
    if _is_float(dtype):
        x = torch.randn(shape, generator=gen).to(_dt(dtype))
    else:
        x = torch.randint(-1000, 1000, shape, generator=gen, dtype=torch.int64).to(_dt(dtype))
    return torch.sort(x, dim=-1, stable=True).values if sort else x


def _lens(bsz: int, n: int, gen: torch.Generator) -> torch.Tensor:
    return torch.randint(0, n + 1, (bsz,), generator=gen, dtype=torch.int32)


def _build(contract: KernelContract, cfg: LatticeConfig, device, seed: int = 0):
    """``(fn, args, expected_outputs, diff_argnums)`` for one point; the
    arguments are drawn on the CPU from ``seed`` and moved to ``device``,
    so two devices get the same values.  ``expected_outputs`` is a list of
    ``(shape, dtype_name)``; ``diff_argnums`` indexes the float arguments
    a gradient flows to (empty unless differentiable)."""
    import repro_torch.kernels.ops as ops
    from repro_torch.kernels import ssm_scan as sc

    gen = torch.Generator().manual_seed(seed)
    name, dt, vd = contract.name, cfg.dtype, VALUE_DTYPE
    kw = dict(tile=cfg.tile, leaf=cfg.leaf)
    n, bsz, k = cfg.n, cfg.batch, min(cfg.k, cfg.n)
    na, nb = _split(n)
    fl = _is_float(dt)

    def vals(shape):
        return torch.randn(shape, generator=gen).to(_dt(vd))

    if name == "merge":
        fn = lambda a, b: ops.merge(a, b, **kw)  # noqa: E731
        args, out, diff = [_keys((na,), dt, gen, True), _keys((nb,), dt, gen, True)], [((n,), dt)], ()
    elif name == "merge_kv":
        fn = lambda ak, av, bk, bv: ops.merge_kv(ak, av, bk, bv, **kw)  # noqa: E731
        args = [_keys((na,), dt, gen, True), vals((na,)), _keys((nb,), dt, gen, True), vals((nb,))]
        out, diff = [((n,), dt), ((n,), vd)], ()
    elif name == "merge_batched":
        fn = lambda a, b: ops.merge_batched(a, b, **kw)  # noqa: E731
        args, out, diff = [_keys((bsz, na), dt, gen, True), _keys((bsz, nb), dt, gen, True)], [((bsz, n), dt)], ()
    elif name == "merge_kv_batched":
        fn = lambda ak, av, bk, bv: ops.merge_kv_batched(ak, av, bk, bv, **kw)  # noqa: E731
        args = [_keys((bsz, na), dt, gen, True), vals((bsz, na)), _keys((bsz, nb), dt, gen, True), vals((bsz, nb))]
        out, diff = [((bsz, n), dt), ((bsz, n), vd)], ()
    elif name == "merge_batched_ragged":
        fn = lambda a, b, la, lb: ops.merge_batched_ragged(a, b, la, lb, **kw)  # noqa: E731
        args = [_keys((bsz, na), dt, gen, True), _keys((bsz, nb), dt, gen, True), _lens(bsz, na, gen),
                _lens(bsz, nb, gen)]
        out, diff = [((bsz, n), dt)], ()
    elif name == "merge_kv_batched_ragged":
        fn = lambda ak, av, bk, bv, la, lb: ops.merge_kv_batched_ragged(ak, av, bk, bv, la, lb, **kw)  # noqa: E731
        args = [_keys((bsz, na), dt, gen, True), vals((bsz, na)), _keys((bsz, nb), dt, gen, True), vals((bsz, nb)),
                _lens(bsz, na, gen), _lens(bsz, nb, gen)]
        out, diff = [((bsz, n), dt), ((bsz, n), vd)], ()
    elif name == "sort":
        fn = lambda x: ops.sort(x, **kw)  # noqa: E731
        args, out, diff = [_keys((n,), dt, gen)], [((n,), dt)], ((0,) if fl else ())
    elif name == "sort_kv":
        fn = lambda ks, vs: ops.sort_kv(ks, vs, **kw)  # noqa: E731
        args, out, diff = [_keys((n,), dt, gen), vals((n,))], [((n,), dt), ((n,), vd)], ((0, 1) if fl else (1,))
    elif name == "sort_batched":
        fn = lambda x: ops.sort_batched(x, **kw)  # noqa: E731
        args, out, diff = [_keys((bsz, n), dt, gen)], [((bsz, n), dt)], ((0,) if fl else ())
    elif name == "sort_kv_batched":
        fn = lambda ks, vs: ops.sort_kv_batched(ks, vs, **kw)  # noqa: E731
        args = [_keys((bsz, n), dt, gen), vals((bsz, n))]
        out, diff = [((bsz, n), dt), ((bsz, n), vd)], ((0, 1) if fl else (1,))
    elif name == "merge_k":
        n_run = max(1, n // cfg.runs)
        fn = lambda runs, lens: ops.merge_k(runs, lens, **kw)  # noqa: E731
        args = [_keys((cfg.runs, n_run), dt, gen, True), _lens(cfg.runs, n_run, gen)]
        out, diff = [((cfg.runs * n_run,), dt)], ()
    elif name == "topk_batched":
        fn = lambda x: ops.topk_batched(x, k, **kw)  # noqa: E731
        args, out, diff = [_keys((bsz, n), dt, gen)], [((bsz, k), dt), ((bsz, k), "int32")], ((0,) if fl else ())
    elif name == "topk_batched_ragged":
        fn = lambda x, ln: ops.topk_batched_ragged(x, k, ln, **kw)  # noqa: E731
        args = [_keys((bsz, n), dt, gen), _lens(bsz, n, gen)]
        out, diff = [((bsz, k), dt), ((bsz, k), "int32")], ((0,) if fl else ())
    elif name == "ssm_scan":
        b, s, d, st = cfg.batch, cfg.seq, cfg.d_model, cfg.state
        fn = lambda dtt, x, bm, cm, a: sc.ssm_scan(dtt, x, bm, cm, a, chunk=cfg.chunk)  # noqa: E731
        args = [(torch.rand((b, s, d), generator=gen) * 0.1 + 0.01).to(_dt(dt)), _keys((b, s, d), dt, gen),
                _keys((b, s, st), dt, gen), _keys((b, s, st), dt, gen),
                (-torch.rand((d, st), generator=gen)).to(_dt(dt))]
        out, diff = [((b, s, d), dt), ((b, d, st), "float32")], ((0, 1, 2, 3, 4) if fl else ())
    else:
        raise KeyError(f"no call builder for contract {name!r}: add one to repro_torch.analysis.checker._build")
    return fn, [a.to(device) for a in args], out, (diff if contract.differentiable else ())


def _outputs(out) -> list:
    return list(out) if isinstance(out, (tuple, list)) else [out]


# ---------------------------------------------------------------------------
# A001: the wrapper's outputs against the contract's signature model
# ---------------------------------------------------------------------------


def shape_violations(contract: KernelContract, cfg: LatticeConfig, device=None) -> List[Violation]:
    """A001 at one point, the wrapper run on ``device`` (``None``: the
    card, as for every entry point of the port; ``"cpu"``: the plain
    versions)."""
    device = resolve_device(device)
    fn, args, expected, _ = _build(contract, cfg, device)
    refused = contract.kind == "scan" and device.type == "cuda" and _scan_refused(cfg)
    try:
        outs = _outputs(fn(*args))
    except ValueError as e:
        if refused:
            return []  # the kernel refuses these operands, loudly, as it must
        return [Violation("A001", contract.name, cfg.describe(), f"the call failed: ValueError: {e}")]
    except Exception as e:  # the call must not fail on a valid point
        return [Violation("A001", contract.name, cfg.describe(), f"the call failed: {type(e).__name__}: {e}")]
    if refused:
        return [Violation("A001", contract.name, cfg.describe(),
                          "operands the kernel refuses (check_kernel_rules) ran instead of raising ValueError")]
    if len(outs) != len(expected):
        return [Violation("A001", contract.name, cfg.describe(), f"expected {len(expected)} outputs, got {len(outs)}")]
    vs = []
    for i, (o, (shape, dtype)) in enumerate(zip(outs, expected)):
        if tuple(o.shape) != tuple(shape) or o.dtype != _dt(dtype):
            vs.append(Violation("A001", contract.name, cfg.describe(),
                                f"output {i}: got {tuple(o.shape)}/{o.dtype}, contract says {tuple(shape)}/{dtype}"))
    return vs


# ---------------------------------------------------------------------------
# A002: block coverage and divisibility (+ loud rejection of non-pow2 sort tiles)
# ---------------------------------------------------------------------------


def _wide_widths(m: int, tile: int) -> List[int]:
    """Run widths of the flat rounds (K3/K4) for an m-element row."""
    w = 1
    while w < m and 2 * w <= tile:
        w *= 2
    out = []
    while w < m:
        out.append(w)
        w *= 2
    return out


def _span_of(kernel: str, dims: Tuple[int, ...]) -> int:
    from repro_torch.kernels import merge_path as mp

    return {"merge": mp.MERGE_SPAN, "merge_kv": mp.MERGE_KV_SPAN}.get(
        kernel, mp.MERGE_ROWS_KV_SPAN if "kv" in kernel else mp.MERGE_ROWS_SPAN)


def _launch_divisibility(launch: Launch) -> List[str]:
    """Why the blocks of one launch would not cover its work exactly."""
    from repro_torch.kernels import merge_path as mp

    k, d, why = launch.kernel, launch.dims, []
    if k in ("merge", "merge_kv") or k in _ROW_KERNELS:
        rows, na, nb = (1,) + d if len(d) == 2 else d
        n, span = na + nb, _span_of(k, d)
        blocks = _cdiv(n, span)
        covered = sum(min(span, n - j * span) for j in range(blocks))
        if covered != n or blocks * span < n or (blocks - 1) * span >= n:
            why.append(f"{blocks} blocks of {span} outputs do not cover a row of {n} exactly")
        if rows * blocks > _INT32_MAX:
            why.append(f"{rows} rows of {blocks} blocks exceed the 2^31 - 1 blocks of a grid")
    elif k in ("sort_round", "sort_round_kv"):
        m, width, tile = d
        span = mp.round_span(m, width, k == "sort_round_kv")
        if not (_is_pow2(width) and _is_pow2(tile)) or (2 * width) % tile:
            why.append(f"round width {width}: tile {tile} does not divide 2 * width")
        if m % (2 * width) or m % tile:
            why.append(f"round width {width}: data {m} is not a multiple of 2 * width and of the tile {tile}")
        if span % (2 * width) and (2 * width) % span:
            why.append(f"round width {width}: a block of {span} outputs straddles a pair")
    elif k in ("sort_tiles", "sort_tiles_kv"):
        n, chunk = d
        block = mp.SORT_TILES_WARP_SPAN if chunk <= mp.SORT_TILES_WARP_SPAN else mp.MAX_TILE
        if not (_is_pow2(chunk) and 2 <= chunk <= mp.MAX_TILE) or n % chunk or block % chunk:
            why.append(f"chunk {chunk}: blocks of {block} keys do not hold whole chunks of a buffer of {n}")
    elif k == "ssm_scan" and d[4] and d[4] % 32:
        why.append(f"checkpoints every {d[4]} steps do not fall on the kernel's 32-step tiles")
    return why


def block_divisibility_violations(contract: KernelContract, cfg: LatticeConfig) -> List[Violation]:
    vs = []
    name, tile, leaf = contract.name, cfg.tile, cfg.leaf
    if contract.kind != "scan" and not 1 <= min(leaf, tile):
        vs.append(Violation("A002", name, cfg.describe(), f"leaf {leaf} unusable"))
    if contract.pow2_tile:
        if not _is_pow2(tile):
            vs.append(Violation(
                "A002", name, cfg.describe(),
                f"sort tile {tile} is not a power of two (flat rounds need tile | 2 * width with pow2 widths)"))
        else:
            for w in _wide_widths(_pow2_ceil(cfg.n), tile):
                if (2 * w) % tile:
                    vs.append(Violation("A002", name, cfg.describe(),
                                        f"round width {w}: tile {tile} does not divide 2*width"))
    for launch in kernel_launches(contract, cfg) + kernel_launches(contract, cfg, grad=True):
        for why in _launch_divisibility(launch):
            vs.append(Violation("A002", name, cfg.describe(), f"{launch.kernel}: {why}"))
    return vs


def rejection_violations(contract: KernelContract, bad_tile: int = 96, device=None) -> List[Violation]:
    """pow2_tile contracts must REJECT a non-pow2 tile, not run it (on
    ``device``, the card when ``None``)."""
    device = resolve_device(device)
    if not contract.pow2_tile:
        return []
    cfg = LatticeConfig(n=4096, tile=bad_tile, leaf=8)
    fn, args, _, _ = _build(contract, cfg, device)
    try:
        fn(*args)
    except ValueError:
        return []  # loud rejection: exactly what the contract demands
    except Exception as e:
        return [Violation("A002", contract.name, cfg.describe(),
                          f"non-pow2 tile {bad_tile} raised {type(e).__name__} instead of ValueError")]
    return [Violation("A002", contract.name, cfg.describe(), f"non-pow2 tile {bad_tile} was silently accepted")]


# ---------------------------------------------------------------------------
# A003: every block's reads stay inside the buffers
# ---------------------------------------------------------------------------


def _spad_slots(n: int, size: int) -> int:
    from repro_torch.kernels import merge_path as mp

    return mp._spad_slots(n, size)


def _spad(i: int, size: int) -> int:
    """``spad<T>(i)`` of csrc/segment_merge.cuh: the slot of element ``i``."""
    return i + (i // (128 // size)) * (4 // size)


def _corank_range(na: int, nb: int, d: int) -> Tuple[int, int]:
    """Algorithm 2's interval at diagonal ``d``: ``co_rank_warp`` returns
    a value in it whatever the data, sorted or not."""
    return max(0, d - nb), min(d, na)


def _probes(na: int, nb: int, d: int) -> List[Tuple[str, int, int]]:
    """``co_rank_warp``'s device reads at diagonal ``d``: ``a[i]`` and
    ``b[d - 1 - i]`` for ``lo <= i < hi`` (a probe past ``hi`` reads
    nothing), as ``(side, first, end)``."""
    lo, hi = _corank_range(na, nb, d)
    return [("A", lo, hi), ("B", d - hi, d - lo)] if lo < hi else []


def _windows(o0: int, n: int, r0: int, r1: int) -> List[Tuple[str, int, int]]:
    """The two windows a block stages from the co-ranks ``r0`` at its
    first diagonal ``o0`` and ``r1`` at its last, ``o0 + n``, as
    ``merge_block`` (and a round's block inside a pair) clamps them: ``wa =
    clamp(r1 - r0, 0, n)``, A ``[r0, r0 + wa)``, B ``[o0 - r0, o0 - r0 + n
    - wa)``.  Each end is monotone in both co-ranks, so over their
    intervals the extremes lie at the corners."""
    wa = min(max(r1 - r0, 0), n)
    return [("A", r0, r0 + wa), ("B", o0 - r0, o0 - r0 + n - wa)]


def _cover(first: int, end: int, vec: int, clip: int) -> Tuple[int, int]:
    """What ``stage_window`` (``load_windows``) reads to stage ``[first,
    end)``: the ``vec``-element vectors of the window's 16-byte-aligned
    cover, which at the worst alignment starts ``vec - 1`` elements before
    ``first`` and ends ``vec - 1`` after ``end`` (one vector even for an
    empty window), each read whole only inside ``[0, clip)``, the length
    the kernel is given, and element by element inside it otherwise."""
    return max(first - (vec - 1), 0), min(end + vec - 1, clip)


def _block_reads(na: int, nb: int, o0: int, n: int, vec: int) -> List[Tuple[str, int, int]]:
    """Every device read of one block that merges outputs ``o0 .. o0 + n``
    of ``a[0:na]`` and ``b[0:nb]`` (``merge_block``): the two co-rank
    searches and the covers of the two staged windows, over every co-rank
    the searches can return."""
    reads = _probes(na, nb, o0) + _probes(na, nb, o0 + n)
    (l0, h0), (l1, h1) = _corank_range(na, nb, o0), _corank_range(na, nb, o0 + n)
    for r0 in (l0, h0):
        for r1 in (l1, h1):
            for side, first, end in _windows(o0, n, r0, r1):
                reads.append((side, *_cover(first, end, vec, na if side == "A" else nb)))
    return reads


class Reach(NamedTuple):
    """What one launch touches, as :func:`launch_reads` models it:
    ``reads`` maps each array the kernel reads in device memory to the
    first element read and the end of the last (``(0, 0)`` when it reads
    none), in the buffer the wrapper allocates; ``writes`` likewise past
    the data (a round's sentinel tail); ``smem`` is the largest element
    index a block's merge reads in shared memory and ``slots`` the slots
    its buffer holds, each ``(slot, slots)`` by array."""

    reads: Dict[str, Tuple[int, int]]
    writes: Dict[str, Tuple[int, int]]
    smem: Dict[str, Tuple[int, int]]


def _widen(ext: Dict[str, Tuple[int, int]], key: str, first: int, end: int) -> None:
    if first < end:
        lo, hi = ext.get(key, (first, end))
        ext[key] = (min(lo, first), max(hi, end))


def launch_reads(launch: Launch) -> Reach:
    """The reads of every block of ``launch``, mirroring its source:

    * a merge (K1/K2, K5-K8): each block's two ``co_rank_warp`` searches
      (Algorithm 2's interval at its first and last diagonal) and the
      covers of its two staged windows (``merge_block``'s clamp of ``wa``,
      ``stage_window``'s vectors clipped to the row's length), each row at
      its offset and stride in its buffer; a ragged row's lengths are
      clamped to ``[0, na]`` and ``[0, nb]`` and every read to them, so the
      full lengths bound it;
    * a round (K3/K4): a block inside a pair searches and stages as a
      merge block does, from the pair's base, a block of whole pairs
      stages ``[o0, o0 + n)`` and an empty window at its end, with the
      covers clipped to the ``m + tile`` elements the kernel is told the
      buffer holds; the extra block writes the ``tile`` sentinels;
    * the tile sort (S1): each thread its ``min(valid, 16)`` elements of
      its block's whole chunks;
    * in shared memory, the segment merge reads one element past each
      side's end: up to index ``n`` of a block's ``n`` outputs (S1's
      passes: of its block's elements).
    """
    from repro_torch.kernels import merge_path as mp

    k, d = launch.kernel, launch.dims
    kb = _esize(launch.key)
    arrays = {"keys": 16 // kb, **({"values": 4} if "kv" in k else {})}  # each array's elements a vector
    reads: Dict[str, Tuple[int, int]] = {}
    writes: Dict[str, Tuple[int, int]] = {}
    top, span = 0, 0
    if k in ("merge", "merge_kv") or k in _ROW_KERNELS:
        rows, na, nb = (1,) + d if len(d) == 2 else d
        a_off, a_stride, _, b_off, b_stride, _ = launch.layout or (0, na, na, 0, nb, nb)
        span = _span_of(k, d)
        for j in range(_cdiv(na + nb, span)):
            o0 = j * span
            n = min(span, na + nb - o0)
            top = max(top, n)
            for arr, vec in arrays.items():
                for side, first, end in _block_reads(na, nb, o0, n, vec):
                    off, stride = (a_off, a_stride) if side == "A" else (b_off, b_stride)
                    _widen(reads, f"{side} {arr}", off + first, off + (rows - 1) * stride + end)
    elif k in ("sort_round", "sort_round_kv"):
        m, width, tile = d
        span = mp.round_span(m, width, k == "sort_round_kv")
        for j in range(_cdiv(m, span)):
            o0 = j * span
            n = min(span, m - o0)
            if 2 * width > span:  # inside one pair: A the pair's first run, B its second
                base, dg = o0 & ~(2 * width - 1), o0 - (o0 & ~(2 * width - 1))
                at = {"A": base, "B": base + width}
                probes = _probes(width, width, dg) + _probes(width, width, dg + span)
                (l0, h0), (l1, h1) = _corank_range(width, width, dg), _corank_range(width, width, dg + span)
                windows = [w for r0 in (l0, h0) for r1 in (l1, h1) for w in _windows(dg, span, r0, r1)]
                top = max(top, span)
            else:  # whole pairs: one window, and an empty one at its end
                at, probes, windows = {"A": 0, "B": 0}, [], [("A", o0, o0 + n), ("B", o0 + n, o0 + n)]
                top = max(top, n)
            for arr, vec in arrays.items():
                for side, first, end in probes:
                    _widen(reads, arr, at[side] + first, at[side] + end)
                for side, first, end in windows:
                    _widen(reads, arr, *_cover(at[side] + first, at[side] + end, vec, m + tile))
        for arr in arrays:
            _widen(writes, arr, m, m + tile)
    elif k in ("sort_tiles", "sort_tiles_kv"):
        n, chunk = d
        span = mp.SORT_TILES_WARP_SPAN if chunk <= mp.SORT_TILES_WARP_SPAN else mp.MAX_TILE
        for j in range(_cdiv(n, span)):
            o0 = j * span
            valid = min(span, n - o0)  # the threads' runs of 16 tile [o0, o0 + valid)
            for arr in arrays:
                _widen(reads, arr, o0, o0 + valid)
            if chunk > 16:  # the merge passes: a pair's last thread reads the element after it
                top = max(top, valid)
    smem = {arr: (_spad(top, size), _spad_slots(span + 1, size))
            for arr, size in (("keys", kb), ("values", 4))[:len(arrays)] if span}
    return Reach(reads, writes, smem)


def _buffers(launch: Launch, pad: int) -> Dict[str, int]:
    """The elements of each array's buffer: a merge's operands as the
    wrapper passes them (``layout``), ``pad`` past them; the flat sort
    buffer's ``m`` data elements and ``pad`` past them."""
    k, d = launch.kernel, launch.dims
    if k in ("merge", "merge_kv") or k in _ROW_KERNELS:
        rows, na, nb = (1,) + d if len(d) == 2 else d
        _, _, a_buf, _, _, b_buf = launch.layout or (0, na, na, 0, nb, nb)
        return {f"{side} {arr}": buf + pad for side, buf in (("A", a_buf), ("B", b_buf)) for arr in ("keys", "values")}
    m = d[0]
    return {"keys": m + pad, "values": m + pad}


def prefetch_violations(contract: KernelContract, cfg: LatticeConfig,
                        pad_elems: Optional[int] = None) -> List[Violation]:
    """Check each launch's modeled reads (:func:`launch_reads`), and a
    round's tail writes, against the buffers the wrapper allocates.

    ``pad_elems`` overrides the modeled padding past the data: the flat
    sort buffer's ``tile`` sentinels, and none past a merge's operands or
    the tile sort's input (they read only what they are given).  The tests
    pass ``0`` for the sorts, and ``-1`` for the merges, to model a buffer
    the kernel outruns and assert this rule fires.
    """
    vs = []
    for launch in kernel_launches(contract, cfg):
        k = launch.kernel
        rounds = k in ("sort_round", "sort_round_kv")
        pad = (launch.dims[2] if rounds else 0) if pad_elems is None else pad_elems
        reach = launch_reads(launch)
        buffers = _buffers(launch, pad)
        for what, ext in (("reads", reach.reads), ("writes", reach.writes)):
            for arr, (first, end) in sorted(ext.items()):
                if first < 0 or end > buffers[arr]:
                    vs.append(Violation("A003", contract.name, cfg.describe(),
                                        f"{k} {launch.dims}: {arr} {what} reach [{first}, {end}) but the buffer holds "
                                        f"{buffers[arr]} elements"))
        for arr, (slot, slots) in sorted(reach.smem.items()):
            if slot >= slots:
                vs.append(Violation("A003", contract.name, cfg.describe(),
                                    f"{k} {launch.dims}: a block reads {arr} slot {slot} of {slots} in shared memory"))
    return vs


# ---------------------------------------------------------------------------
# A004: sentinel / masked-rank policy
# ---------------------------------------------------------------------------


def sentinel_violations(contract: KernelContract) -> List[Violation]:
    if contract.kind == "scan":
        return []  # no rank path, no sentinels
    vs = []
    if (contract.carries_values or contract.ragged) and not contract.masked_ranks:
        what = "values" if contract.carries_values else "ragged lengths"
        vs.append(Violation(
            "A004", contract.name, "-",
            f"carries {what} on an UNMASKED rank path: a window pad tied with a real +inf / iinfo.max key can "
            f"steal its slot and leak a zero value (the sentinel-collision bug class)"))
    if not contract.masked_ranks and not contract.tie_safe:
        vs.append(Violation(
            "A004", contract.name, "-",
            "unmasked rank path without a tie_safe justification: state why sentinel-tied real keys still merge "
            "bit-exactly"))
    return vs


# ---------------------------------------------------------------------------
# A005: shared memory against the per-block budget
# ---------------------------------------------------------------------------


def smem_violations(
    contract: KernelContract,
    cfg: LatticeConfig,
    budgets: Optional[Dict[str, int]] = None,
    usable_fraction: float = SMEM_USABLE_FRACTION,
) -> List[Violation]:
    budgets = SMEM_BUDGET_BYTES if budgets is None else budgets
    need = smem_bytes(contract, cfg)
    vs = []
    for dev, cap in sorted(budgets.items()):
        limit = int(cap * usable_fraction)
        if need > limit:
            vs.append(Violation(
                "A005", contract.name, cfg.describe(),
                f"a block's shared memory {need} B exceeds the {dev} budget {limit} B ({usable_fraction:.0%} of "
                f"{cap} B)"))
    return vs


# ---------------------------------------------------------------------------
# A006: gradients of the differentiable contracts
# ---------------------------------------------------------------------------


def grad_violations(contract: KernelContract, cfg: LatticeConfig, device=None) -> List[Violation]:
    """A006 at one point, the backward run on ``device`` (the card when
    ``None``)."""
    device = resolve_device(device)
    if not contract.differentiable:
        return []
    fn, args, _, argnums = _build(contract, cfg, device)
    if not argnums:
        return []
    args = [a.requires_grad_() if i in argnums else a for i, a in enumerate(args)]
    try:
        with torch.enable_grad():
            outs = _outputs(fn(*args))
            loss = sum(o.float().sum() for o in outs if o.is_floating_point())
            grads = torch.autograd.grad(loss, [args[i] for i in argnums])
    except Exception as e:
        return [Violation("A006", contract.name, cfg.describe(), f"the backward failed: {type(e).__name__}: {e}")]
    vs = []
    for i, g in zip(argnums, grads):
        a = args[i]
        if tuple(g.shape) != tuple(a.shape) or g.dtype != a.dtype:
            vs.append(Violation("A006", contract.name, cfg.describe(),
                                f"cotangent of arg {i}: {tuple(g.shape)}/{g.dtype} != primal "
                                f"{tuple(a.shape)}/{a.dtype}"))
    return vs


# ---------------------------------------------------------------------------
# A000 + the sweep over every contract
# ---------------------------------------------------------------------------


def completeness_violations(contracts: Optional[Dict[str, KernelContract]] = None) -> List[Violation]:
    """Every public ``kernels.ops`` callable (and the selective scan) must
    be registered: an unannotated kernel is an unchecked kernel."""
    import repro_torch.kernels.ops as ops

    contracts = registered_contracts() if contracts is None else contracts
    vs = []
    for name, obj in sorted(vars(ops).items()):
        if name.startswith("_") or not callable(obj) or isinstance(obj, type):
            continue
        if getattr(obj, "__module__", None) != "repro_torch.kernels.ops":
            continue
        if name not in contracts:
            vs.append(Violation("A000", name, "-",
                                "public kernels.ops entry point has no kernel_contract annotation: add one"))
    if "ssm_scan" not in contracts:
        vs.append(Violation("A000", "ssm_scan", "-", "the fused selective scan has no kernel_contract annotation"))
    return vs


def _configs_for(contract: KernelContract, fast: bool, trace: bool) -> List[LatticeConfig]:
    if contract.kind == "scan":
        return scan_lattice(fast)
    return trace_lattice(fast) if trace else model_lattice()


def check_contract(
    contract: KernelContract,
    *,
    fast: bool = False,
    budgets: Optional[Dict[str, int]] = None,
    trace: bool = True,
    device=None,
) -> List[Violation]:
    """All rules for one contract over its lattice slices; with ``trace``
    the wrapper runs on ``device`` at the trace points (``None``: the
    card, and without one it raises; ``"cpu"``: the plain versions)."""
    device = resolve_device(device)
    vs = sentinel_violations(contract)
    for cfg in _configs_for(contract, fast, trace=False):
        vs += block_divisibility_violations(contract, cfg)
        vs += prefetch_violations(contract, cfg)
        vs += smem_violations(contract, cfg, budgets)
    if trace:
        vs += rejection_violations(contract, device=device)
        trace_cfgs = _configs_for(contract, fast, trace=True)
        for cfg in trace_cfgs:
            vs += shape_violations(contract, cfg, device)
        # one backward per contract proves the gradient composes: the first float point the kernels take
        for cfg in trace_cfgs:
            if _is_float(cfg.dtype) and not (contract.kind == "scan" and _scan_refused(cfg)):
                vs += grad_violations(contract, cfg, device)
                break
    return vs


def check_kernels(
    *,
    fast: bool = False,
    budgets: Optional[Dict[str, int]] = None,
    trace: bool = True,
    device=None,
) -> List[Violation]:
    """Registry completeness plus every rule on every registered contract.
    ``fast=True`` shrinks the trace lattice (the closed-form rules always
    sweep the whole model lattice).  ``device=None`` is the card, as for
    every entry point of the port (without one it raises); ``"cpu"`` runs
    the plain versions and launches nothing."""
    device = resolve_device(device)
    import repro_torch.kernels.ops  # noqa: F401  (its decorators fill the registry)
    import repro_torch.kernels.ssm_scan  # noqa: F401

    contracts = registered_contracts()
    vs = completeness_violations(contracts)
    for name in sorted(contracts):
        vs += check_contract(contracts[name], fast=fast, budgets=budgets, trace=trace, device=device)
    return vs


# ---------------------------------------------------------------------------
# What the ops really call: the wrappers, observed
# ---------------------------------------------------------------------------


class Call(NamedTuple):
    """One observed wrapper call: the :class:`Launch` it makes (on a CUDA
    tensor) or would make (its plain version on a CPU one), the wrapper's
    plain version, its arguments and its outputs."""

    launch: Launch
    ref: object
    args: tuple
    kwargs: dict
    out: object


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _observed_launch(kernel: str, args, kwargs) -> Launch:
    if kernel in ("merge", "merge_kv"):
        a, b = (args[0], args[1]) if kernel == "merge" else (args[0], args[2])
        return Launch(kernel, _dtype_name(a), (a.shape[0], b.shape[0]))
    if kernel in _ROW_KERNELS:
        a = args[0]
        b = args[2] if "kv" in kernel else args[1]
        return Launch(kernel, _dtype_name(a), (a.shape[0], a.shape[1], b.shape[1]))
    if kernel in ("sort_round", "sort_round_kv"):
        kf, width = args[0], args[2 if kernel == "sort_round_kv" else 1]
        tile = kwargs["tile"]
        return Launch(kernel, _dtype_name(kf), (kf.shape[0] - tile, width, tile))
    if kernel in ("sort_tiles", "sort_tiles_kv"):
        kf, chunk = args[0], args[-1]
        return Launch(kernel, _dtype_name(kf), (kf.shape[0], chunk))
    if kernel == "ssm_scan":  # _forward(dt, x, bmat, cmat, a, chunk, checkpoints)
        x, bm, chunk, ckpt = args[1], args[2], args[5], args[6]
        return Launch(kernel, _dtype_name(x), tuple(x.shape) + (bm.shape[-1], chunk if ckpt else 0))
    x, bm = args[1], args[2]  # ssm_scan_bwd
    return Launch(kernel, _dtype_name(x), tuple(x.shape) + (bm.shape[-1],))


@contextlib.contextmanager
def observe_wrappers():
    """Record every kernel-wrapper call the ops make inside the block (a
    list of :class:`Call`, yielded).  The merge-path wrappers are replaced
    in ``kernels.merge_path``'s namespace, where the ops look them up; the
    selective scan's by its launching functions ``_forward`` and
    ``ssm_scan_bwd``.  Each replacement calls the wrapper itself, so the
    launch counts move as they would."""
    from repro_torch.kernels import merge_path as mp
    from repro_torch.kernels import ssm_scan as sc

    calls: List[Call] = []
    saved = []

    class Observed:
        """Calls the wrapper and records the call; its ``launches`` is the
        wrapper's, which the wrapper counts through the module global this
        stands in for."""

        def __init__(self, fn, kernel, ref):
            self.fn, self.kernel, self.ref = fn, kernel, ref

        def __call__(self, *args, **kwargs):
            out = self.fn(*args, **kwargs)
            calls.append(Call(_observed_launch(self.kernel, args, kwargs), self.ref, args, kwargs, out))
            return out

        @property
        def launches(self):
            return self.fn.launches

        @launches.setter
        def launches(self, value):
            self.fn.launches = value

    def wrap(module, attr, kernel, ref):
        fn = getattr(module, attr)
        saved.append((module, attr, fn))
        setattr(module, attr, Observed(fn, kernel, ref))

    for name in ("merge", "merge_kv", "sort_round", "sort_round_kv", "sort_tiles", "sort_tiles_kv") + _ROW_KERNELS:
        wrap(mp, name, name, getattr(mp, f"{name}_ref"))
    wrap(sc, "_forward", "ssm_scan", sc.ssm_scan_ref)
    wrap(sc, "ssm_scan_bwd", "ssm_scan_bwd", sc.ssm_scan_bwd_ref)
    try:
        yield calls
    finally:
        for module, attr, fn in reversed(saved):
            setattr(module, attr, fn)


def trace_points(fast: bool = False):
    """Every (contract, trace point) the A001 sweep runs, the scan's points
    for the scan contract: ``[(contract, cfg), ...]``."""
    import repro_torch.kernels.ops  # noqa: F401
    import repro_torch.kernels.ssm_scan  # noqa: F401

    contracts = registered_contracts()
    return [(contracts[name], cfg) for name in sorted(contracts)
            for cfg in _configs_for(contracts[name], fast, trace=True)]


class PointCalls(NamedTuple):
    """The wrapper calls one trace point's op made (``grad``: with its
    backward), as :func:`launch_model_calls` observed them."""

    contract: KernelContract
    cfg: LatticeConfig
    grad: bool
    calls: List[Call]


def launch_model_calls(fast: bool = False, device=None) -> List[PointCalls]:
    """Run the op of every trace point on ``device`` (the card when
    ``None``), and its backward where the contract is differentiable,
    under :func:`observe_wrappers`, and hold the wrappers it calls, in
    order and at their geometry, to :func:`kernel_launches`: the launch
    model that A002, A003 and A005 read.  Raises ``RuntimeError`` at the
    first point where they differ; returns every point's calls.  A scan
    point the kernel refuses launches nothing and is left out (A001 holds
    its refusal)."""
    device = resolve_device(device)
    out = []
    for contract, cfg in trace_points(fast):
        if contract.kind == "scan" and _scan_refused(cfg):
            continue
        for grad in (False, True):
            fn, args, _, argnums = _build(contract, cfg, device)
            if grad and not argnums:
                continue
            args = [a.requires_grad_() if grad and i in argnums else a for i, a in enumerate(args)]
            with observe_wrappers() as calls, torch.enable_grad():
                outs = _outputs(fn(*args))
                if grad:
                    torch.autograd.grad(sum(o.float().sum() for o in outs if o.is_floating_point()),
                                        [args[i] for i in argnums])
            got = [c.launch[:3] for c in calls]
            want = [launch[:3] for launch in kernel_launches(contract, cfg, grad=grad)]
            if got != want:
                raise RuntimeError(f"launch model: {contract.name} {cfg.describe()} grad={grad}: the op called {got}, "
                                   f"the model says {want}")
            out.append(PointCalls(contract, cfg, grad, calls))
    return out


# ---------------------------------------------------------------------------
# What each source says its launch requests (the card only)
# ---------------------------------------------------------------------------

_SOURCE = {"merge": "merge", "merge_kv": "merge", "sort_round": "sort_round", "sort_round_kv": "sort_round",
           "sort_tiles": "sort_tiles", "sort_tiles_kv": "sort_tiles", "ssm_scan": "ssm_scan",
           "ssm_scan_bwd": "ssm_scan_bwd", **dict.fromkeys(_ROW_KERNELS, "merge")}


def source_smem(launch: Launch) -> Tuple[int, int]:
    """``(dynamic, static)``: the dynamic shared memory the launch requests
    as its source computes it (``<kernel>_smem_bytes`` of
    ``csrc/<source>.cu``, the function its launch sizes the request with),
    and its kernel's static shared memory (``cudaFuncGetAttributes``).
    Builds the library if needed; needs the card."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels import merge_path as mp

    k = launch.kernel
    fn = getattr(_build.load(_SOURCE[k]), f"{k}_smem_bytes")
    fn.restype = ctypes.c_int64
    static = ctypes.c_int64(-1)
    if k.startswith("ssm_scan"):
        bf = launch.key == "bfloat16"
        flags = (1 | 2 | 4 | 8 | (16 if k == "ssm_scan_bwd" else 0)) if bf else 0
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)]
        dyn = fn(launch.dims[3], flags, ctypes.byref(static))
    else:
        code = mp.KEY_CODE[_dt(launch.key)]
        if k.startswith("sort_round"):
            fn.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
            dyn = fn(code, launch.dims[0], launch.dims[1], ctypes.byref(static))
        elif k.startswith("sort_tiles"):
            fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)]
            dyn = fn(code, launch.dims[1], ctypes.byref(static))
        else:
            fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int64)]
            dyn = fn(code, ctypes.byref(static))
    if dyn < 0 or static.value < 0:
        raise RuntimeError(f"{k}_smem_bytes failed for {launch}")
    return int(dyn), int(static.value)


def all_launches(fast: bool = False) -> List[Launch]:
    """Every distinct launch of every contract (and of its gradient) over
    the model and trace lattices, the scan's over its own: what the card's
    A005 check holds each source to."""
    import repro_torch.kernels.ops  # noqa: F401
    import repro_torch.kernels.ssm_scan  # noqa: F401

    seen = {}
    for contract in registered_contracts().values():
        for cfg in _configs_for(contract, fast, trace=False) + _configs_for(contract, fast, trace=True):
            for launch in kernel_launches(contract, cfg) + kernel_launches(contract, cfg, grad=True):
                seen.setdefault(launch[:3], launch)
    return list(seen.values())
