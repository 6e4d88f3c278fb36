"""The port's kernel checker against the reference's, and each rule firing.

* the port's contract registry equals the reference's flag for flag
  (``ssm_scan_pallas`` is the port's ``ssm_scan``), but for the
  differences listed in ``DIFFERENCES`` with their reasons;
* ``model_lattice``, ``trace_lattice`` and ``scan_lattice`` equal the
  reference's without its ``engine`` axis;
* ``check_kernels(device="cpu")`` is clean and moves no launch count, and
  the CLI says so;
* the launch model (``kernel_launches``) equals the wrapper calls the ops
  really make on CPU tensors, at every trace point and in the backward;
* every entry point of the checker raises without a card unless the
  caller names the CPU;
* each rule fires on a known-bad input, as ``tests/test_analysis.py``
  holds the reference's.

Everything runs on the CPU: the wrappers take their plain versions and
nothing is built.
"""

import dataclasses

import pytest
import torch

from repro.analysis import lattice as ref_lattice
from repro.analysis import registered_contracts as ref_registered_contracts
import repro.kernels.ops  # noqa: F401  (its decorators fill the reference's registry)
import repro.kernels.ssm_scan  # noqa: F401
from repro_torch.analysis import (
    SMEM_BUDGET_BYTES,
    LatticeConfig,
    Violation,
    block_divisibility_violations,
    check_contract,
    check_kernels,
    completeness_violations,
    grad_violations,
    model_lattice,
    prefetch_violations,
    registered_contracts,
    rejection_violations,
    scan_lattice,
    sentinel_violations,
    shape_violations,
    smem_bytes,
    smem_violations,
    trace_lattice,
)
from repro_torch.analysis import checker as ck
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.kernels import WRAPPERS, reset_launches
from repro_torch.kernels import merge_path as kmp
from repro_torch.kernels import ssm_scan as ksc

CONTRACTS = registered_contracts()
# The port's flags that differ from the reference's, with why: the
# reference's keys-only merges rank on an unmasked path (and say why a tie
# with a pad is harmless); every port kernel ends each side of a merge by
# index, never by comparing against a sentinel (csrc/segment_merge.cuh).
DIFFERENCES = {
    "merge": {"masked_ranks": True, "tie_safe": None},
    "merge_batched": {"masked_ranks": True, "tie_safe": None},
}
FLAGS = ("kind", "batched", "ragged", "carries_values", "masked_ranks", "pow2_tile", "differentiable", "tie_safe")


def test_registry_matches_the_reference_flag_for_flag():
    ref = {("ssm_scan" if k == "ssm_scan_pallas" else k): v for k, v in ref_registered_contracts().items()}
    assert set(CONTRACTS) == set(ref) and len(CONTRACTS) == 14
    for name, contract in CONTRACTS.items():
        want = {f: getattr(ref[name], f) for f in FLAGS}
        want.update(DIFFERENCES.get(name, {}))
        assert {f: getattr(contract, f) for f in FLAGS} == want, name
    assert completeness_violations(CONTRACTS) == []


def _fields(cfg, drop=("engine",)):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name not in drop}


def test_lattices_match_the_reference_without_the_engine_axis():
    ref_model = []
    for cfg in ref_lattice.model_lattice():  # the reference's 144 points, two engines each
        if _fields(cfg) not in ref_model:
            ref_model.append(_fields(cfg))
    assert len(model_lattice()) == 72 and [_fields(c) for c in model_lattice()] == ref_model
    for fast in (True, False):
        assert [_fields(c) for c in trace_lattice(fast)] == [_fields(c) for c in ref_lattice.trace_lattice(fast)]
        assert [_fields(c) for c in scan_lattice(fast)] == [_fields(c) for c in ref_lattice.scan_lattice(fast)]


def test_clean_tree_passes_on_the_cpu_and_launches_nothing():
    reset_launches()
    violations = check_kernels(fast=True, device="cpu")
    assert violations == [], "\n".join(map(str, violations))
    assert sum(fn.launches for fn in WRAPPERS) == 0


def test_cli_on_the_cpu(capsys):
    assert analysis_main(["--device", "cpu", "--fast"]) == 0
    out = capsys.readouterr().out
    assert "14 contracts proven" in out and "0 kernel launches" in out


ENTRY_POINTS = {
    "check_kernels": lambda: check_kernels(fast=True),
    "check_contract": lambda: check_contract(CONTRACTS["merge"], fast=True),
    "shape_violations": lambda: shape_violations(CONTRACTS["merge"], LatticeConfig(n=1000, tile=128)),
    "rejection_violations": lambda: rejection_violations(CONTRACTS["sort"]),
    "grad_violations": lambda: grad_violations(CONTRACTS["sort"], LatticeConfig(n=1000, tile=128)),
    "launch_model_calls": lambda: ck.launch_model_calls(fast=True),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_no_card_means_no_fallback(name):
    """Every entry point of the checker runs on the card unless the caller
    names the CPU: without a card it raises instead of checking the plain
    versions."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    reset_launches()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()
    assert sum(fn.launches for fn in WRAPPERS) == 0


def test_launch_model_equals_the_wrapper_calls():
    """At every trace point the op calls exactly the wrappers, in order and
    at the geometry, that ``kernel_launches`` predicts (``launch_model_calls``
    raises where they differ; a scan point the kernel refuses is left out)."""
    points = ck.launch_model_calls(fast=True, device="cpu")
    assert {p.contract.name for p in points} == set(CONTRACTS)
    for p in points:
        assert [c.launch[:3] for c in p.calls] == [x[:3] for x in ck.kernel_launches(p.contract, p.cfg, grad=p.grad)]
    seen = {c.launch.kernel for p in points for c in p.calls}
    assert seen == {"merge", "merge_kv", "sort_round", "sort_round_kv", "sort_tiles", "sort_tiles_kv", "ssm_scan",
                    "ssm_scan_bwd", *ck._ROW_KERNELS}
    # a model that disagrees with the ops is caught
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ck, "kernel_launches", lambda contract, cfg, grad=False: [])
        with pytest.raises(RuntimeError, match="launch model"):
            ck.launch_model_calls(fast=True, device="cpu")


def test_a000_fires_on_missing_annotation():
    vs = completeness_violations(contracts={})
    assert vs and all(v.rule == "A000" for v in vs)
    assert any(v.kernel == "merge" for v in vs) and any(v.kernel == "ssm_scan" for v in vs)


def test_a002_fires_on_non_pow2_sort_tile():
    vs = block_divisibility_violations(CONTRACTS["sort"], LatticeConfig(n=4096, tile=384))
    assert any(v.rule == "A002" and "power of two" in v.message for v in vs)


def test_a002_fires_on_silently_accepted_bad_tile():
    # ops.merge takes any tile, so a contract that CLAIMS pow2 rejection for it must be caught
    bad = CONTRACTS["merge"].with_(pow2_tile=True)
    vs = rejection_violations(bad, bad_tile=96, device="cpu")
    assert any(v.rule == "A002" and "silently accepted" in v.message for v in vs)


def test_a002_clean_on_real_sort_rejection():
    for name in ("sort", "sort_kv", "sort_batched", "sort_kv_batched", "topk_batched", "topk_batched_ragged"):
        assert rejection_violations(CONTRACTS[name], bad_tile=96, device="cpu") == [], name


def test_a003_fires_when_sentinel_padding_removed():
    cfg = LatticeConfig(n=4096, tile=512)
    # the flat sort buffer's tail of `tile` sentinels removed: the rounds' vector reads and tail run off the end
    for name in ("sort", "sort_kv_batched", "topk_batched"):
        vs = prefetch_violations(CONTRACTS[name], cfg, pad_elems=0)
        assert vs and all(v.rule == "A003" for v in vs), name
        assert prefetch_violations(CONTRACTS[name], cfg) == [], name
    # the port's merges need no padding at all; one element short, their reads run past the buffer
    for name in ("merge", "merge_kv_batched_ragged", "merge_k"):
        assert prefetch_violations(CONTRACTS[name], cfg, pad_elems=0) == [], name
        assert any(v.rule == "A003" for v in prefetch_violations(CONTRACTS[name], cfg, pad_elems=-1)), name


def test_a003_reach_follows_the_kernels_windows():
    """The modeled reads are the kernels' own: a round's last window is read
    by 16-byte vectors up to ``16 / size - 1`` elements past the data, into
    the sentinel tail, and no further; a merge reads its operands exactly;
    merge_k's rows are read in place at their strides."""
    for key, vec in (("int32", 4), ("int16", 8)):
        reach = ck.launch_reads(ck.Launch("sort_round_kv", key, (4096, 512, 512)))
        assert reach.reads == {"keys": (0, 4096 + vec - 1), "values": (0, 4096 + 3)}
        assert reach.writes == {"keys": (4096, 4608), "values": (4096, 4608)}
    reach = ck.launch_reads(ck.Launch("merge", "float32", (2730, 1366)))
    assert reach.reads == {"A keys": (0, 2730), "B keys": (0, 1366)} and reach.smem["keys"][0] < reach.smem["keys"][1]
    merge_k = ck.kernel_launches(CONTRACTS["merge_k"], LatticeConfig(n=4096, tile=512))
    assert [ck.launch_reads(x).reads for x in merge_k] == [{"A keys": (0, 3072), "B keys": (1024, 4096)},
                                                         {"A keys": (0, 2048), "B keys": (2048, 4096)}]


def test_a003_fires_without_the_kernels_vector_guard(monkeypatch):
    """``stage_window`` reads a vector whole only inside the length it is
    given; without that guard the cover of the last row's window runs past
    the operand, and A003 says so."""
    cfg = LatticeConfig(n=4096, tile=512)
    monkeypatch.setattr(ck, "_cover", lambda first, end, vec, clip: (max(first - (vec - 1), 0), end + vec - 1))
    for name in ("merge", "merge_kv_batched", "merge_k"):
        vs = prefetch_violations(CONTRACTS[name], cfg)
        assert vs and all(v.rule == "A003" for v in vs), name
    # the flat sort buffer's tail of `tile` sentinels holds an unguarded cover
    assert prefetch_violations(CONTRACTS["sort"], cfg) == []


def test_a004_fires_on_unmasked_values_contract():
    bad = CONTRACTS["merge_kv"].with_(masked_ranks=False)
    assert any(v.rule == "A004" and "UNMASKED" in v.message for v in sentinel_violations(bad))
    # an unmasked keys-only contract without justification also fails
    bad = CONTRACTS["merge"].with_(masked_ranks=False)
    assert any(v.rule == "A004" for v in sentinel_violations(bad))
    for c in CONTRACTS.values():
        assert sentinel_violations(c) == []


def test_a005_fires_on_a_shared_memory_overflow():
    # K10 at state 16 in float32 requests 221312 B: inside the 227 KB of a block, past 90 % of it
    scan = LatticeConfig(dtype="float32", batch=1, seq=64, d_model=64, state=16)
    assert smem_bytes(CONTRACTS["ssm_scan"], scan) == 221312
    assert smem_violations(CONTRACTS["ssm_scan"], scan) == []
    vs = smem_violations(CONTRACTS["ssm_scan"], scan, usable_fraction=0.9)
    assert vs and all(v.rule == "A005" for v in vs)
    # and against a tiny budget even the default merge does not fit
    vs = smem_violations(CONTRACTS["merge"], LatticeConfig(), budgets={"tiny": 1024})
    assert any(v.rule == "A005" and "tiny" in v.message for v in vs)


def test_a005_smem_model_is_monotone_and_fits_the_defaults():
    m = lambda dtype, name="merge": smem_bytes(CONTRACTS[name], LatticeConfig(dtype=dtype))  # noqa: E731
    assert 0 < m("bfloat16") < m("float32") < m("float32", "merge_kv")
    # the scan's backward layout outweighs its forward's
    scan = LatticeConfig(dtype="float32", state=16)
    assert smem_bytes(CONTRACTS["ssm_scan"].with_(differentiable=False), scan) < smem_bytes(CONTRACTS["ssm_scan"], scan)
    # every contract fits at the defaults and on the model lattice, K9 at 120 KB as its source says
    assert ksc.smem_bytes(16, False, False) == 123008 and ksc.smem_bytes(4, False, False) == 0
    for c in CONTRACTS.values():
        for cfg in [LatticeConfig()] + (scan_lattice() if c.kind == "scan" else model_lattice()):
            assert 0 <= smem_bytes(c, cfg) <= SMEM_BUDGET_BYTES["h100"]
    # a round's block: the widest, and the narrower one a small round takes
    assert kmp.round_span(1 << 24, 1 << 20, True) == kmp.SORT_ROUND_KV_SPAN
    assert kmp.round_span(1 << 24, 1 << 20, False) == kmp.SORT_ROUND_SPAN
    assert kmp.round_span(32768, 512, True) == 256 and kmp.round_span(1 << 24, 2, False) == 1024


def test_violation_formatting():
    v = Violation("A005", "merge", "tile=65536", "too big")
    assert "A005" in str(v) and "merge" in str(v)
