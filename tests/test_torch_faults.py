"""The port's fault injector and guarded dispatch against the reference's.

The plan grammar, ``should_fire`` and the ``inject`` stack are held to
the reference's on the same plans; ``nan_lace`` and ``corrupt`` to its
bit for bit on one salt.  Then every fault class on every op that phase
12 of ``chip_smoke.py`` drives, on the plain path (CPU tensors): the
reference walks its fallback chain and serves from a later edge, the port
has one attempt and raises (``GuardedDispatchError`` for ``launch`` and
``vmem``, ``VerificationError`` for ``exchange`` and ``nan``) exactly
where the reference's first attempt failed, both record the same first
fired event (class, op, call index), and the port's health counters say
what happened.  The reference's side runs in six subprocesses (one an op) started
when the module starts (its jit compiles take most of its time), each
running this module's input helpers and ``reference_outcomes`` without
the port's imports, while the port's side runs here.
Last, ROADMAP R10's NaN-laced inputs raise ``VerificationError`` from
``ops.merge`` and ``ops.merge_k`` with verification on.
"""

import inspect
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.runtime import faults as RF
from repro_torch import telemetry as PT
from repro_torch.kernels import merge_path as km
from repro_torch.kernels import ops
from repro_torch.kernels import ssm_scan as ks
from repro_torch.runtime import faults as PF
from repro_torch.runtime import resilience as res
from repro_torch.runtime.resilience import GuardedDispatchError, VerificationError

ROOT = Path(__file__).resolve().parents[1]
OPS = ("merge", "sort", "sort_kv", "merge_batched_ragged", "merge_k", "topk_batched_ragged")
CLASSES = ("launch", "vmem", "exchange", "nan")
RAISES = {"launch": "GuardedDispatchError", "vmem": "GuardedDispatchError", "exchange": "VerificationError",
          "nan": "VerificationError"}
# the port's counters of a call that raised, by class (calls and exhausted are 1 each)
COUNTERS = {"launch": {"launch_failures": 1, "faults_injected": 1}, "vmem": {"precondition_rejects": 1, "faults_injected": 1},
            "exchange": {"verify_failures": 1, "faults_injected": 1}, "nan": {"verify_failures": 1}}


def _inputs():
    """Each op's numpy operands, from a seed; small enough that the
    reference's first attempt takes its core path inside the tile."""
    rng = np.random.default_rng(7)
    f32 = np.float32
    return {
        "merge": (np.sort(rng.standard_normal(30).astype(f32)), np.sort(rng.standard_normal(20).astype(f32))),
        "sort": (rng.standard_normal(50).astype(f32),),
        "sort_kv": (rng.standard_normal(50).astype(f32), np.arange(50, dtype=np.int32)),
        "merge_batched_ragged": (np.sort(rng.standard_normal((3, 20)).astype(f32), 1),
                                 np.sort(rng.standard_normal((3, 15)).astype(f32), 1),
                                 np.array([20, 5, 0], np.int32), np.array([15, 15, 7], np.int32)),
        "merge_k": (np.sort(rng.standard_normal((5, 12)).astype(f32), 1), np.array([12, 3, 0, 6, 12], np.int32)),
        "topk_batched_ragged": (rng.standard_normal((2, 60)).astype(f32), np.array([60, 33], np.int32)),
    }


def _call(mod, op: str, args):
    """``op`` of ``mod`` (either package's ``ops``) on converted arguments."""
    if op == "topk_batched_ragged":
        return mod.topk_batched_ragged(args[0], 8, args[1])
    return getattr(mod, op)(*args)


def reference_outcomes(names) -> dict:
    """The reference's side of every (op, class) case of ``names``: its
    health record and fired events.  Runs in a subprocess."""
    import jax
    import jax.numpy as jnp

    from repro import telemetry as RT
    from repro.kernels import ops as rops

    warnings.simplefilter("ignore")
    out = {}
    for op in names:
        args = [jnp.asarray(a) for a in _inputs()[op]]
        for cls in CLASSES:
            with RT.use(RT.Telemetry()) as tel, RF.inject(f"{cls}:{op}:0"):
                jax.block_until_ready(_call(rops, op, args))
                out[f"{op}:{cls}"] = {"health": tel.health[op].as_dict(),
                                      "fired": [[e.cls, e.op, e.index, e.label] for e in RF.fired_events()]}
    return out


def _probe() -> str:
    """The reference's side as a script: this module's input and call
    helpers and :func:`reference_outcomes`, without the port's imports."""
    return "\n".join(["import json, sys, warnings", "import numpy as np", "from repro.runtime import faults as RF",
                      f"CLASSES = {CLASSES!r}", *(inspect.getsource(f) for f in (_inputs, _call, reference_outcomes)),
                      "print(json.dumps(reference_outcomes(sys.argv[1:])))"])


@pytest.fixture(scope="module", autouse=True)
def reference():
    """Start the reference's side (one process an op) and give a
    function that waits for it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", _probe(), OPS[i]], env=env, cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE) for i in range(len(OPS))]
    done = {}

    def wait():
        if not done:
            for proc in procs:
                out, err = proc.communicate(timeout=300)
                assert proc.returncode == 0, err[-3000:]
                done.update(json.loads(out.strip().splitlines()[-1]))
        return done

    yield wait
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# ---------------------------------------------------------------------------
# the plan grammar and state
# ---------------------------------------------------------------------------

PLANS = ["launch:merge:0,2;nan:sort*:*", "vmem:*:1:kernel", "exchange:distributed_merge:0:window", " launch:x ; ",
         "nan:topk_batched_ragged:3,4,5"]


@pytest.mark.parametrize("plan", PLANS)
def test_plans_parse_as_the_reference_parses_them(plan):
    def fields(specs):
        return [(s.cls, s.op, s.indices, s.match) for s in specs]

    assert fields(PF.parse_plan(plan)) == fields(RF.parse_plan(plan))


@pytest.mark.parametrize("plan", ["bogus:merge", "launch", "launch:a:1:b:c", "launch:merge:x"])
def test_bad_plans_raise_in_both_packages(plan):
    with pytest.raises(ValueError):
        RF.parse_plan(plan)
    with pytest.raises(ValueError):
        PF.parse_plan(plan)


def test_should_fire_and_the_inject_stack_restore_state():
    PF.reset_counters()
    assert not PF.active()
    assert [PF.next_index("merge") for _ in range(3)] == [0, 1, 2]
    with PF.inject("launch:merge:1"):
        assert PF.active() and PF.next_index("merge") == 0  # fresh counters inside
        assert not PF.should_fire("launch", "merge", 0, label="kernel")
        assert PF.should_fire("launch", "merge", 1, label="kernel")
        with PF.inject("exchange:sort*:*:plain"):
            assert PF.should_fire("exchange", "sort_kv", 9, label="plain")
            assert not PF.should_fire("exchange", "sort_kv", 9, label="kernel")  # the match filters labels
            assert PF.should_fire("launch", "merge", 1)  # the outer plan stays in force
            assert len(PF.fired_events()) == 2
        assert [(e.cls, e.op, e.index) for e in PF.fired_events()] == [("launch", "merge", 1)]
        assert not PF.should_fire("exchange", "sort", 0, label="plain")
    assert not PF.active() and PF.fired_events() == []
    assert PF.next_index("merge") == 3  # the outer counters came back
    PF.reset_counters()


def test_a_spec_without_a_match_fires_on_the_ports_one_attempt():
    with PF.inject("launch:merge:0"), RF.inject("launch:merge:0"):
        assert PF.should_fire("launch", "merge", 0, label="plain")
        assert RF.should_fire("launch", "merge", 0, label="pallas-hier")
        assert not RF.should_fire("launch", "merge", 0, label="core", last=True)  # the reference's oracle


def test_env_plan(monkeypatch):
    """``REPRO_FAULTS`` drives both packages; the port's second sort raises."""
    monkeypatch.setenv("REPRO_FAULTS", "launch:sort:1")
    PF.reset_counters()
    RF.reset_counters()
    assert PF.active() and RF.active()
    assert PF.should_fire("launch", "sort", 1) and RF.should_fire("launch", "sort", 1, label="pallas-hier")
    x = torch.randn(40, generator=torch.Generator().manual_seed(0))
    with PT.use(PT.Telemetry()) as tel:
        assert torch.equal(ops.sort(x), torch.sort(x, stable=True).values)
        with pytest.raises(GuardedDispatchError, match=r"injected launch failure: sort\[1\] plain"):
            ops.sort(x)
        assert tel.health["sort"].as_dict()["served_by"] == {"plain": 1}
        assert tel.health["sort"].launch_failures == 1
    PF.reset_counters()
    RF.reset_counters()


# ---------------------------------------------------------------------------
# the payload mutators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1000,), (3, 50), (1,)])
def test_nan_lace_equals_the_reference(shape):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    got = PF.nan_lace(torch.from_numpy(x), "merge:4:0").numpy()
    want = RF.nan_lace(x, "merge:4:0")
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert np.isnan(got).sum() == max(1, x.size // 8)
    ints = torch.arange(8, dtype=torch.int32)
    assert PF.nan_lace(ints, "s") is ints


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_corrupt_equals_the_reference(dtype):
    x = np.sort(np.random.default_rng(4).integers(-50, 50, 300)).astype(dtype)
    if dtype == np.float32:
        x[[5, 77]] = np.nan
    got = PF.corrupt((torch.from_numpy(x), torch.arange(3)), "s")
    want = RF.corrupt(x, "s")
    np.testing.assert_array_equal(got[0].numpy().view(np.int32), want.view(np.int32))
    assert torch.equal(got[1], torch.arange(3))
    const = torch.full((5,), 2.0)
    assert PF.corrupt(const) is const


# ---------------------------------------------------------------------------
# phase 12 on the CPU (while the reference's side runs)
# ---------------------------------------------------------------------------


def test_chip_phase_runs_on_the_cpu():
    """Phase 12 at small sizes on CPU tensors, the trace smoke in-process
    (``tests/test_torch_telemetry.py`` runs it): every check of the phase
    runs; nothing is launched or timed."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    out = chip_smoke.phase_runtime(device="cpu", log2n=10, rows=(6, 300), log2_run=7, vocab=600, routing=(1, 384, 8),
                                   scan=(1, 40, 24, 8), reduce=True, smoke=False)
    assert out["serving"]["completed"] == 3 and out["serving"]["retries"] == 2
    assert out["costs"] == {}  # nothing is timed on the CPU
    assert out["faults"]["launch:merge"] == {"raised": "GuardedDispatchError", "launches": 0}


# ---------------------------------------------------------------------------
# every fault class on every op of phase 12, on the plain path
# ---------------------------------------------------------------------------


def _port_outcome(op: str, cls: str) -> dict:
    args = [torch.from_numpy(a.copy()) for a in _inputs()[op]]
    with PT.use(PT.Telemetry()) as tel, PF.inject(f"{cls}:{op}:0"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            _call(ops, op, args)
            raised = None
        except (GuardedDispatchError, VerificationError) as e:
            raised = type(e).__name__
        return {"raised": raised, "health": tel.health[op].as_dict(),
                "fired": [[e.cls, e.op, e.index, e.label] for e in PF.fired_events()]}


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("cls", CLASSES)
def test_fault_raises_where_the_reference_degrades(reference, op, cls):
    port, ref = _port_outcome(op, cls), reference()[f"{op}:{cls}"]
    assert [e[:3] for e in port["fired"][:1]] == [e[:3] for e in ref["fired"][:1]]
    assert all(e[3] in ("plain", "") for e in port["fired"])
    h = port["health"]
    assert h["calls"] == 1 and h["fallbacks"] == 0
    if ref["health"]["fallbacks"]:  # the reference's first attempt failed: the port raises
        assert port["raised"] == RAISES[cls]
        assert h["exhausted"] == 1 and h["served_by"] == {}
        for name in ("launch_failures", "precondition_rejects", "verify_failures", "faults_injected"):
            assert h[name] == COUNTERS[cls].get(name, 0), name
    else:  # a sort of NaN-laced keys is a correct total-order sort; merge_k laces nothing
        assert port["raised"] is None and h["served_by"] == {"plain": 1} and h["exhausted"] == 0


def test_ssm_scan_launch_fault_raises():
    gen = torch.Generator().manual_seed(5)
    dt, x = torch.rand(1, 5, 8, generator=gen), torch.rand(1, 5, 8, generator=gen)
    bm, cm = torch.rand(1, 5, 4, generator=gen), torch.rand(1, 5, 4, generator=gen)
    a = -torch.rand(8, 4, generator=gen)
    with PT.use(PT.Telemetry()) as tel:
        want = ks.ssm_scan(dt, x, bm, cm, a)
        with PF.inject("launch:ssm_scan_pallas:1"):
            assert ks.ssm_scan(dt, x, bm, cm, a)[0].equal(want[0])
            with pytest.raises(GuardedDispatchError, match="ssm_scan_pallas"):
                ks.ssm_scan(dt, x, bm, cm, a)
        assert tel.health["ssm_scan_pallas"].as_dict()["served_by"] == {"plain": 2}


# ---------------------------------------------------------------------------
# ROADMAP R10: NaN-laced keys, and the guard's switches
# ---------------------------------------------------------------------------


def _r10():
    rng = np.random.default_rng(10)
    a = np.sort(rng.standard_normal(300).astype(np.float32))
    b = np.sort(rng.standard_normal(200).astype(np.float32))
    runs = np.sort(rng.standard_normal((4, 64)).astype(np.float32), 1)
    return [torch.from_numpy(RF.nan_lace(t, f"r10:{i}")) for i, t in enumerate((a, b, runs))]


def test_r10_nan_laced_keys_raise_verification_error(monkeypatch):
    a, b, runs = _r10()
    monkeypatch.setenv("REPRO_GUARD_VERIFY", "1")
    with pytest.raises(VerificationError, match="merge"):
        ops.merge(a, b, tile=64)
    with pytest.raises(VerificationError, match="merge_k"):
        ops.merge_k(runs, tile=64)
    monkeypatch.setenv("REPRO_GUARD", "0")  # without the guard the unsorted output comes back (R10)
    out = ops.merge(a, b, tile=64)
    assert not bool(res.keys_ordered(out))


def test_verified_clean_calls_equal_the_unguarded_ones(monkeypatch):
    a, b, runs = (torch.from_numpy(np.nan_to_num(t.numpy(), nan=0.5)) for t in _r10())
    a, b, runs = torch.sort(a).values, torch.sort(b).values, torch.sort(runs, 1).values
    monkeypatch.setenv("REPRO_GUARD_VERIFY", "1")
    with PT.use(PT.Telemetry()) as tel:
        got = (ops.merge(a, b, tile=64), ops.merge_k(runs, tile=64), ops.sort(a, tile=64))
        assert tel.health["merge"].served_by == {"plain": 1} and tel.health["merge_k"].served_by == {"plain": 1}
        assert tel.health["merge_batched_ragged"].calls == 2  # merge_k's rounds are guarded calls
    monkeypatch.setenv("REPRO_GUARD", "0")
    with PT.use(PT.Telemetry()) as tel:
        want = (ops.merge(a, b, tile=64), ops.merge_k(runs, tile=64), ops.sort(a, tile=64))
        assert tel.health == {} and tel.spans == []
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_preflight_checks_geometry_and_shared_memory():
    assert res.preflight("merge", {"n": 10, "tile": 64, "leaf": 8, "smem": 1024}, "kernel", 0) == []
    assert "not a power of two" in res.preflight("sort", {"n": 10, "tile": 96, "leaf": 8}, "kernel", 0)[0]
    assert "exceeds" in res.preflight("merge", {"n": 10, "smem": res.SMEM_PER_BLOCK + 1}, "kernel", 0)[0]
    assert "outside" in res.preflight("merge", {"n": 2**31, "tile": 64}, "kernel", 0)[0]
    assert "leaf" in res.preflight("merge", {"n": 10, "tile": 64, "leaf": 65}, "kernel", 0)[0]
    # the requests of the widest blocks, from csrc's spans: K1 float32, K2, K4, S1 with values at chunk 4096
    assert km.smem_bytes("merge", 4) == 33808
    assert km.smem_bytes("merge", 4, values=True) == 2 * 16912
    assert km.smem_bytes("round", 4, values=True) == 2 * (2049 + 65 + 2) * 4
    assert km.smem_bytes("tiles", 4, values=True, chunk=4096) == 4 * 16912
    assert km.smem_bytes("tiles", 2, chunk=512) == 2 * 536 * 2
    assert max(km.smem_bytes(k, b, v) for k in ("merge", "rows", "round", "tiles") for b in (2, 4)
               for v in (False, True)) < res.SMEM_PER_BLOCK
