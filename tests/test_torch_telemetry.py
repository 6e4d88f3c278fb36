"""The port's telemetry against the reference's: spans, registries, export and the trace CLI.

Span nesting and the out-of-order unwind, ``use`` and ``reset_telemetry``,
snapshots merged across registries, and the CLI's ``check`` and ``diff``
are driven the same way in both packages and compared.  The parity test
is the reference's own fault-injected serving run
(``tests/test_telemetry.py``: reduced tinyllama, greedy, 3 requests,
``launch:serving.decode:1``), served by the port on the same weights:
the two tick-clocked traces are the same bytes.  The trace smoke
(``python -m repro_torch.telemetry.smoke --device cpu``) writes a trace
that the port's ``--check`` passes.
"""

import json

import jax
import numpy as np
import pytest

from repro import telemetry as RT
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.runtime import faults as RF
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxEngine
from repro.telemetry import __main__ as ref_cli
from repro_torch import telemetry as PT
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.runtime import faults as PF
from repro_torch.runtime import resilience as res
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.telemetry import __main__ as cli
from repro_torch.telemetry import smoke


def _drive(mod):
    """One event stream on a fresh tick-clocked registry of ``mod``: nested
    spans, an exception unwinding two, a span left open, instruments."""
    clock = mod.TickClock()
    with mod.use(mod.Telemetry(clock)) as tel:
        with tel.span("outer", k=1):
            clock.advance()
            with tel.span("mid"):
                inner = tel.begin("inner", x=2)
                tel.end(inner)
        try:
            with tel.span("a"):
                with tel.span("b"):
                    raise KeyError("unwind")
        except KeyError:
            pass
        tel.begin("open")
        tel.counter("c").add(3)
        tel.gauge("g").set(2.5)
        tel.gauge("g").set(1.0)
        for v in (1, 7, 30, 700):
            tel.histogram("h").record(v)
    return tel


def test_spans_nest_and_unwind_as_the_reference():
    port, ref = _drive(PT), _drive(RT)
    assert [(s.name, s.start, s.end, s.depth, s.attrs) for s in port.spans] == \
        [(s.name, s.start, s.end, s.depth, s.attrs) for s in ref.spans]
    assert [s.name for s in port.unclosed()] == ["open"]
    assert port.spans[2].duration == ref.spans[2].duration and port.spans[-1].duration is None
    assert port.span_stats() == ref.span_stats()
    assert port.histograms["h"].stats() == ref.histograms["h"].stats() and port.histograms["h"].count == 4
    assert PT.trace_json_bytes(port) == RT.trace_json_bytes(ref)
    assert PT.summary(port) == RT.summary(ref)


def test_use_stacks_registries_and_reset_zeroes_the_active_one():
    root = PT.get_telemetry()
    with PT.use(PT.Telemetry()) as a:
        assert PT.get_telemetry() is a
        with PT.use(PT.Telemetry()) as b:
            PT.get_telemetry().counter("x").add(1)
            res.health("merge").calls += 1
        assert PT.get_telemetry() is a and "x" not in a.counters
        assert b.counters["x"].value == 1 and b.health["merge"].calls == 1
        a.counter("y").add(2)
        PT.reset_telemetry()
        assert a.counters == {} and a.health == {}
    assert PT.get_telemetry() is root


def test_snapshots_merge_as_the_reference():
    snaps = []
    for mod in (PT, RT):
        src, dst = _drive(mod), mod.Telemetry()
        dst.gauge("g").set(9.0)
        dst.merge_snapshot(json.loads(json.dumps(src.snapshot())))
        dst.merge_snapshot(src.snapshot())
        snaps.append((dst.snapshot(), {k: g.as_dict() for k, g in dst.gauges.items()}))
    assert snaps[0] == snaps[1]
    assert snaps[0][0]["counters"] == {"c": 6} and snaps[0][1]["g"] == {"last": 2.5, "min": 1.0, "max": 9.0}


def test_cli_check_and_diff(tmp_path, capsys):
    clean, other = PT.Telemetry(PT.TickClock()), PT.Telemetry(PT.TickClock())
    for tel, ratio in ((clean, 1.0), (other, 1.2)):
        with tel.span("op/merge"):
            tel.gauge("distributed.balance_ratio").set(ratio)
            tel.counter("calls").add(1 if ratio == 1.0 else 2)
    paths = []
    for i, tel in enumerate((clean, other, _drive(PT))):
        paths.append(tmp_path / f"t{i}.json")
        PT.write_trace(tel, paths[-1])
    assert cli.main(["--check", str(paths[0])]) == 0
    assert "OK: 0 unclosed spans; balance_ratio max=1.0000" in capsys.readouterr().out
    assert cli.main(["--check", str(paths[1])]) == 1
    assert "exceeds" in capsys.readouterr().out
    assert cli.main(["--check", str(paths[2])]) == 1
    assert "1 unclosed span(s)" in capsys.readouterr().out
    assert cli.main([str(paths[0]), str(paths[1])]) == 0
    assert capsys.readouterr().out.splitlines() == ["counter calls: 1 -> 2", "gauge distributed.balance_ratio: 1 -> 1.2"]
    traces = [PT.load_trace(p) for p in paths]
    assert cli.check(traces[1], 1.05) == ref_cli.check(traces[1], 1.05)
    assert cli.diff(traces[0], traces[2]) == ref_cli.diff(traces[0], traces[2])
    assert cli.summarize(traces[2]) == ref_cli.summarize(traces[2])


def _serving_trace(tel_mod, faults_mod, engine, request, cfg, params, **kw):
    """The reference test's workload in a fresh registry: ``(report, trace bytes)``."""
    with tel_mod.use(tel_mod.Telemetry()) as tel, faults_mod.inject("launch:serving.decode:1"):
        eng = engine(cfg, params, batch=2, max_seq=32, **kw)
        rng = np.random.default_rng(0)
        for i in range(3):
            eng.submit(request(uid=i, prompt=rng.integers(0, cfg.vocab_size, 4).astype(np.int32), max_new_tokens=2,
                               temperature=0.0))
        rep = eng.run_until_done()
        return rep, tel_mod.trace_json_bytes(tel)


def test_fault_injected_serving_trace_is_byte_identical_to_the_reference():
    """R3's retry path in both packages: the decode of tick 1 fails, the engine
    backs off one tick and retries, all 3 requests complete, and every
    byte of the trace (spans, counters, gauges, health) agrees."""
    jcfg = jax_get_config("tinyllama-1.1b").reduced()
    jparams = jax_init_params(jcfg, jax.random.key(0))
    cfg = get_config("tinyllama-1.1b").reduced()
    params = from_jax_params(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    with pytest.warns(Warning):
        ref_rep, ref_raw = _serving_trace(RT, RF, JaxEngine, JaxRequest, jcfg, jparams)
        rep, raw = _serving_trace(PT, PF, ServingEngine, Request, cfg, params, device="cpu")
        rep2, raw2 = _serving_trace(PT, PF, ServingEngine, Request, cfg, params, device="cpu")
    assert (rep.completed, rep.retries) == (ref_rep.completed, ref_rep.retries) == (3, 1)
    assert raw == raw2  # a replay
    assert raw == ref_raw
    trace = json.loads(raw)
    assert any(ev["args"].get("failed") == "InjectedFault" for ev in trace["traceEvents"])
    assert cli.check(trace, 1.05) == []


def test_trace_smoke_passes_the_check(tmp_path, capsys):
    out = tmp_path / "trace.json"
    assert smoke.main(["--device", "cpu", "--out", str(out)]) == 0
    assert cli.main(["--check", str(out)]) == 0
    assert "balance_ratio max=1.0000" in capsys.readouterr().out
    other = PT.load_trace(out)["otherData"]
    assert other["health"]["distributed_merge"]["served_by"] == {"window": 1}
    assert other["spans"]["serving.tick"]["count"] >= 2
