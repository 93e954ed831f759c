"""The port's telemetry (repro_torch.obs: spans, exporters, report CLI,
planner scoreboard, the gated counters) against the JAX package's
(tests/test_obs.py mirrored), on the CPU.

Parity: the same seeded operands go through both packages with
telemetry on, and the span trees must have equal names and nesting
(a canonical tree of span names ordered by start, ``_tree``); counters
published by both (``batched.*``, ``abft.*``) must be equal.  Durations
differ (two frameworks), so they are held to the contract only: the
synthetic step spans sum to their dispatch span within 10 % (the
reference test's tolerance; they are carved out of the measured
interval, which the span encloses), the dispatch lies within its root.  The
scoreboard and drift check are pure host arithmetic on the same records:
equal to the reference's exactly.  Telemetry off is bitwise the
untraced product and adds no registry entry.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.compat import make_mesh as jax_make_mesh
from repro.core import dbcsr as jdbcsr
from repro.robustness import chaos as jchaos

from conftest import SRC
from torch_threads import one_thread  # noqa: F401

from repro_torch import obs
from repro_torch.core import dbcsr
from repro_torch.core.blocking import GridSpec
from repro_torch.core.multiply import distributed_matmul
from repro_torch.launch.mesh import make_mesh
from repro_torch.robustness import chaos

EXEC_KW = dict(algorithm="cannon", densify=False, local_kernel="ref",
               pipeline_depth=1)


@pytest.fixture()
def rng():
    """A fresh seeded generator a test: this module leaves the session
    generator of tests/conftest.py as it found it."""
    return np.random.RandomState(0)


def _reset(pkg):
    pkg.enable()   # reset=True installs a fresh, empty tracer ...
    pkg.disable()  # ... and the default state is OFF
    pkg.clear_metrics()
    pkg.clear_plan_outcomes()


@pytest.fixture(autouse=True)
def _clean_obs():
    """Every test starts and ends with both packages' telemetry off and
    their stores empty."""
    for pkg in (obs, jobs):
        _reset(pkg)
    yield
    for pkg in (obs, jobs):
        _reset(pkg)


def _mesh11():
    return make_mesh((1, 1), ("data", "model"), device="cpu")


def _pair(rng, m, n, *, block=32, mesh, jmesh):
    """The same seeded host matrix as a port and a JAX operand."""
    data = rng.randn(m, n).astype(np.float32)
    return (dbcsr.create(data, mesh=mesh, block_size=block),
            jdbcsr.create(data, mesh=jmesh, block_size=block))


def _operand(rng, m, n, *, block=32, mesh=None):
    return dbcsr.create(rng.randn(m, n).astype(np.float32), mesh=mesh,
                        block_size=block)


def _spans_by_name(spans, name):
    return [s for s in spans if s.name == name]


def _children(spans, parent):
    return [s for s in spans if s.parent_id == parent.span_id]


def _tree(spans):
    """Span names and nesting as a canonical tree: (name, children)
    with children in start order."""
    kids = {}
    for s in spans:
        kids.setdefault(s.parent_id, []).append(s)

    def walk(pid):
        return tuple((s.name, walk(s.span_id))
                     for s in sorted(kids.get(pid, []),
                                     key=lambda s: (s.t0, s.span_id)))
    return walk(None)


# ---------------------------------------------------------------------------
# metrics registry units (the cases tests/test_torch_service.py leaves out)
# ---------------------------------------------------------------------------


def test_counter_inc_and_negative_rejected():
    c = obs.counter("t.count")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)
    assert obs.counter("t.count") is c


def test_labels_isolate_series():
    a = obs.counter("t.lbl", algo="cannon")
    b = obs.counter("t.lbl", algo="summa")
    a.inc(3)
    assert b.value == 0 and a.value == 3
    assert obs.counter("t.two", x="1", y="2") is obs.counter(
        "t.two", y="2", x="1")


def test_gauge_keeps_sample_history():
    g = obs.gauge("t.occ")
    for v in (0.2, 0.9, 0.4):
        g.set(v)
    assert g.value == 0.4
    assert g.samples == [0.2, 0.9, 0.4]


def test_registry_snapshot_and_clear_match_jax():
    for pkg in (obs, jobs):
        pkg.counter("t.a").inc()
        pkg.gauge("t.b").set(1.0)
        pkg.histogram("t.c").observe(2.0)
        assert len(pkg.registry()) == 3
    assert obs.metrics_snapshot() == jobs.metrics_snapshot()
    obs.clear_metrics()
    assert len(obs.registry()) == 0


def test_public_names_match_jax():
    assert set(jobs.__all__) <= set(obs.__all__)
    assert set(obs.__all__) - set(jobs.__all__) == {"recording", "vetoed"}
    assert obs.EVENTS_LOG == jobs.EVENTS_LOG
    assert obs.PLAN_OUTCOMES_LOG == jobs.PLAN_OUTCOMES_LOG


# ---------------------------------------------------------------------------
# tracer units
# ---------------------------------------------------------------------------


def test_span_nesting_and_last_trace():
    tracer = obs.enable()
    with obs.span("outer", cat="multiply"):
        with obs.span("inner", cat="plan") as sp:
            sp.set(algorithm="cannon")
    outer = _spans_by_name(tracer.spans, "outer")[0]
    inner = _spans_by_name(tracer.spans, "inner")[0]
    assert inner.parent_id == outer.span_id
    assert inner.trace_id == outer.trace_id == outer.span_id
    assert inner.attrs["algorithm"] == "cannon"
    assert {s.name for s in obs.last_trace()} == {"outer", "inner"}


def test_span_disabled_is_shared_noop():
    assert obs.span("x") is obs.NOOP_SPAN
    assert obs.maybe_span(False, "x") is obs.NOOP_SPAN
    obs.enable()
    assert obs.maybe_span(False, "x") is obs.NOOP_SPAN
    obs.disable()
    with obs.span("x") as sp:
        sp.set(ignored=1)
    assert obs.last_trace() == []


def test_span_exception_tagged_and_stack_recovers():
    tracer = obs.enable()
    with pytest.raises(RuntimeError):
        with obs.span("boom"):
            raise RuntimeError("x")
    rec = _spans_by_name(tracer.spans, "boom")[0]
    assert rec.attrs["error"] == "RuntimeError"
    assert tracer.current() is None


def test_event_and_span_records_round_trip_like_jax():
    tracer = obs.enable()
    with obs.span("root", cat="multiply", m=4):
        obs.event("mark", note="x")
    rows = [s.to_dict() for s in tracer.spans]
    back = [jobs.SpanRecord.from_dict(r).to_dict() for r in rows]
    assert back == rows
    assert [obs.SpanRecord.from_dict(r).to_dict() for r in rows] == rows
    (mark,) = _spans_by_name(tracer.spans, "mark")
    (root,) = _spans_by_name(tracer.spans, "root")
    assert mark.parent_id == root.span_id and mark.dur == 0.0


# ---------------------------------------------------------------------------
# exporters and the report CLI
# ---------------------------------------------------------------------------


def _toy_trace():
    obs.enable()
    with obs.span("root", cat="multiply"):
        with obs.span("child", cat="plan"):
            pass
    return obs.last_trace()


def test_chrome_trace_valid_and_written(tmp_path):
    spans = _toy_trace()
    chrome = obs.to_chrome_trace(spans)
    assert obs.validate_chrome_trace(chrome) == []
    # the reference's validator and exporter agree on the same spans
    assert jobs.validate_chrome_trace(chrome) == []
    jspans = [jobs.SpanRecord.from_dict(s.to_dict()) for s in spans]
    want = jobs.to_chrome_trace(jspans, process_name="repro_torch")
    assert chrome == want
    path = str(tmp_path / "trace.json")
    obs.write_chrome_trace(path, spans)
    with open(path) as f:
        assert obs.validate_chrome_trace(json.load(f)) == []


def test_chrome_trace_validator_catches_tampering():
    chrome = obs.to_chrome_trace(_toy_trace())
    xs = [e for e in chrome["traceEvents"] if e["ph"] == "X"]
    xs[0]["dur"] = -5.0
    xs[1]["args"]["parent_id"] = 10 ** 9
    errors = obs.validate_chrome_trace(chrome)
    assert errors and errors == jobs.validate_chrome_trace(chrome)
    assert obs.validate_chrome_trace({"traceEvents": []})
    assert obs.validate_chrome_trace([1, 2, 3])


def test_jsonl_event_log_round_trip(tmp_path):
    log_dir = str(tmp_path / "obs")
    obs.enable(log_dir=log_dir)
    with obs.span("root", cat="multiply"):
        pass
    obs.record_plan_outcome(algorithm="cannon", predicted_s=1.0,
                            measured_s=2.0)
    events = obs.read_jsonl(os.path.join(log_dir, obs.EVENTS_LOG))
    outcomes = obs.read_jsonl(os.path.join(log_dir, obs.PLAN_OUTCOMES_LOG))
    assert [e["name"] for e in events] == ["root"]
    assert outcomes == [{"algorithm": "cannon", "predicted_s": 1.0,
                         "measured_s": 2.0}]
    rec = obs.SpanRecord.from_dict(events[0])
    assert rec.name == "root" and rec.dur >= 0
    assert obs.read_jsonl(str(tmp_path / "missing.jsonl")) == []
    # the reference reads the port's logs
    assert jobs.read_jsonl(os.path.join(log_dir, obs.EVENTS_LOG)) == events


def test_report_cli(tmp_path, capsys):
    from repro_torch.obs import report

    log_dir = str(tmp_path / "obs")
    assert report.main(["--dir", log_dir]) == 1
    capsys.readouterr()
    obs.enable(log_dir=log_dir)
    with obs.span("multiply", cat="multiply"):
        with obs.span("plan", cat="plan"):
            pass
    obs.record_plan_outcome(algorithm="cannon", predicted_s=1.0,
                            measured_s=2.0)
    obs.disable()
    assert report.main(["--dir", log_dir, "--timeline"]) == 0
    out = capsys.readouterr().out
    assert "plan" in out and "cannon" in out and "scoreboard" in out


def test_report_module_cli_runs(tmp_path):
    """``python -m repro_torch.obs report --dir DIR`` in a fresh process
    on a log the port wrote; no subcommand prints the usage."""
    log_dir = str(tmp_path / "obs")
    obs.enable(log_dir=log_dir)
    with obs.span("multiply", cat="multiply"):
        with obs.span("dispatch", cat="dispatch"):
            pass
    obs.record_plan_outcome(kind="multiply", algorithm="summa",
                            predicted_s=1e-3, measured_s=2e-3)
    obs.disable()
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "report", "--dir",
         log_dir, "--timeline"], env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "summa" in proc.stdout and "dispatch" in proc.stdout
    usage = subprocess.run([sys.executable, "-m", "repro_torch.obs"],
                           env=env, capture_output=True, text=True,
                           timeout=120)
    assert usage.returncode == 2 and "usage" in usage.stderr


def test_breakdown_and_timeline_equal_jax():
    obs.enable()
    with obs.span("multiply", cat="multiply"):
        with obs.span("plan", cat="plan"):
            pass
        with obs.span("verify", cat="verify"):
            with obs.span("repair", cat="repair"):
                pass
    spans = obs.last_trace()
    jspans = [jobs.SpanRecord.from_dict(s.to_dict()) for s in spans]
    assert obs.category_breakdown(spans) == jobs.category_breakdown(jspans)
    assert obs.render_breakdown(spans) == jobs.render_breakdown(jspans)
    assert obs.render_timeline(spans) == jobs.render_timeline(jspans)


# ---------------------------------------------------------------------------
# the zero-overhead-off contract and the compile / capture veto
# ---------------------------------------------------------------------------


def test_disabled_is_bitwise_identical_and_adds_no_metrics(rng):
    mesh = _mesh11()
    a = _operand(rng, 128, 128, mesh=mesh)
    b = _operand(rng, 128, 128, mesh=mesh)
    kw = dict(mesh=mesh, **EXEC_KW)

    obs.clear_metrics()
    c_off = dbcsr.multiply(a, b, **kw)
    assert len(obs.registry()) == 0, \
        "disabled multiply must add zero registry entries"
    assert obs.last_trace() == []

    obs.enable()
    c_on = dbcsr.multiply(a, b, **kw)
    obs.disable()
    c_off2 = dbcsr.multiply(a, b, **kw)
    assert torch.equal(c_on.data, c_off.data)
    assert torch.equal(c_off2.data, c_off.data)


def test_disabled_entry_points_add_no_entries(rng):
    """multiply_batched (fused), a verified multiply, a rank-exact
    rebalanced multiply, a contraction and a purification run add no
    registry entry with telemetry off, and give the traced bits."""
    from repro_torch.sparsity.workloads import (banded_hamiltonian,
                                                initial_density,
                                                mcweeny_purify)
    from repro_torch.tensor import contract, create_tensor

    mesh = _mesh11()
    mesh22 = make_mesh((2, 2), ("data", "model"), device="cpu")
    pairs = [(_operand(rng, 64, 64, mesh=mesh),
              _operand(rng, 64, 64, mesh=mesh)) for _ in range(3)]
    a = _operand(rng, 128, 128, mesh=mesh)
    b = _operand(rng, 128, 128, mesh=mesh)
    mask = np.zeros((8, 8), dtype=bool)
    mask[:2] = True
    mask[np.arange(8), np.arange(8)] = True
    sa = dbcsr.create(rng.randn(128, 128).astype(np.float32), mesh=mesh22,
                      block_size=16, block_mask=mask)
    sb = dbcsr.create(rng.randn(128, 128).astype(np.float32), mesh=mesh22,
                      block_size=16, block_mask=mask.T.copy())
    ta = create_tensor(rng.randn(16, 8, 32).astype(np.float32), mesh=mesh,
                       block_sizes=(8, 4, 8))
    tb = create_tensor(rng.randn(32, 16).astype(np.float32), mesh=mesh,
                       block_sizes=(8, 8))
    H, hmask = banded_hamiltonian(128, 16, half_bandwidth=3)
    P0 = dbcsr.create(initial_density(H).astype(np.float32), mesh=mesh,
                      block_size=16, block_mask=hmask)

    def run():
        out = [c.data for c in dbcsr.multiply_batched(
            pairs, mesh=mesh, fused=True, **EXEC_KW)]
        out.append(dbcsr.multiply(a, b, mesh=mesh, verify="checksum",
                                  **EXEC_KW).data)
        out.append(dbcsr.multiply(sa, sb, mesh=mesh22, algorithm="summa",
                                  densify=False, local_kernel="ref",
                                  rebalance=True).data)
        out.append(contract("ijk,kl->ijl", ta, tb, mesh=mesh,
                            densify=False, local_kernel="ref").data)
        P, _ = mcweeny_purify(P0, mesh=mesh, n_iter=2, filter_eps=1e-6,
                              multiply_kw=dict(densify=False,
                                               local_kernel="ref"))
        out.append(P.data)
        return out

    off = run()
    assert len(obs.registry()) == 0
    assert obs.plan_outcomes() == [] and obs.last_trace() == []
    obs.enable()
    on = run()
    obs.disable()
    assert len(obs.registry()) > 0 and obs.plan_outcomes()
    assert obs.counter("planner.rebalance.applied").value == 1
    for x, y in zip(off, on):
        assert torch.equal(x, y)


@pytest.mark.parametrize("veto", ["is_compiling", "capturing"])
def test_enabled_under_compile_or_capture_records_nothing(rng, monkeypatch,
                                                          veto):
    """The port's veto (the reference's jax.jit test): while
    torch.compile traces the caller, or the current CUDA stream captures
    a graph, a multiply records no span and no outcome.  Both are
    patched here (the engine's host planning does not trace under
    torch.compile, and the CPU has no stream to capture)."""
    if veto == "is_compiling":
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
    mesh = _mesh11()
    A = torch.as_tensor(rng.randn(64, 64).astype(np.float32))
    B = torch.as_tensor(rng.randn(64, 64).astype(np.float32))
    tracer = obs.enable()
    assert obs.enabled() and obs.vetoed() and not obs.recording()
    C = distributed_matmul(A, B, mesh=mesh, grid=GridSpec("data", "model"),
                           block_m=32, block_k=32, block_n=32, **EXEC_KW)
    torch.testing.assert_close(C, A @ B, rtol=2e-4, atol=2e-4)
    assert tracer.spans == []
    assert obs.plan_outcomes() == []


def test_recording_follows_the_switch():
    assert not obs.recording() and not obs.vetoed()
    obs.enable()
    assert obs.recording()
    obs.disable()
    assert not obs.recording()


# ---------------------------------------------------------------------------
# traced multiply, fused batch and ABFT repair: trees equal the reference's
# ---------------------------------------------------------------------------


def _traced(pkg, fn):
    pkg.enable()
    try:
        out = fn()
    finally:
        pkg.disable()
    return out, pkg.last_trace(), pkg.plan_outcomes()


def _check_steps_fill_dispatches(spans):
    for disp in _spans_by_name(spans, "dispatch"):
        steps = _children(spans, disp)
        assert steps, "a dispatch must carry schedule-step children"
        assert sum(s.dur for s in steps) == pytest.approx(disp.dur,
                                                          rel=0.1)


def test_traced_multiply_span_tree_and_outcome(rng):
    mesh, jmesh = _mesh11(), jax_make_mesh((1, 1), ("data", "model"))
    a, ja = _pair(rng, 128, 128, mesh=mesh, jmesh=jmesh)
    b, jb = _pair(rng, 128, 128, mesh=mesh, jmesh=jmesh)
    (c, plan), spans, outcomes = _traced(obs, lambda: dbcsr.multiply(
        a, b, mesh=mesh, return_plan=True, **EXEC_KW))
    _, jspans, jout = _traced(jobs, lambda: jdbcsr.multiply(
        ja, jb, mesh=jmesh, return_plan=True, **EXEC_KW))
    assert _tree(spans) == _tree(jspans)

    (root,) = [s for s in spans if s.parent_id is None]
    assert root.name == "multiply" and root.cat == "multiply"
    assert (root.attrs["m"], root.attrs["k"], root.attrs["n"]) == (
        128, 128, 128)
    kids = {s.name: s for s in _children(spans, root)}
    assert set(kids) == {"plan", "dispatch"}
    assert kids["plan"].attrs["algorithm"] == "cannon"
    disp = kids["dispatch"]
    assert disp.attrs["comm_bytes"] >= 0
    assert "device_s" not in disp.attrs      # no device clock on the CPU
    _check_steps_fill_dispatches(spans)
    assert root.dur >= disp.dur > 0
    step_spans = [s for s in _children(spans, disp)
                  if s.cat == "schedule-step"]
    assert all("flops" in s.attrs and "comm_bytes" in s.attrs
               for s in step_spans)
    jdisp = _spans_by_name(jspans, "dispatch")[0]
    assert disp.attrs["comm_bytes"] == jdisp.attrs["comm_bytes"]

    (out,) = outcomes
    assert set(out) == set(jout[0])
    for key in ("kind", "algorithm", "densify", "m", "k", "n", "occupancy",
                "pipeline_depth"):
        assert out[key] == jout[0][key], key
    assert out["predicted_s"] == pytest.approx(float(plan.predicted_s))
    assert 0 < out["measured_s"] <= root.dur
    assert obs.validate_chrome_trace(obs.to_chrome_trace(spans)) == []


def test_traced_multiply_on_2x2_rank_exact_tree_equals_jax():
    """A rank-exact masked Cannon on 2x2: the JAX side runs in a
    subprocess with 4 host devices; names and nesting must agree."""
    code = r"""
import json, sys
import numpy as np
from repro import obs
from repro.compat import make_mesh
from repro.core import dbcsr
rng = np.random.RandomState(3)
mesh = make_mesh((2, 2), ("data", "model"))
mask = rng.rand(8, 8) < 0.4
mask[0, 0] = True
a = dbcsr.create(rng.randn(128, 128).astype(np.float32), mesh=mesh,
                 block_size=16, block_mask=mask)
b = dbcsr.create(rng.randn(128, 128).astype(np.float32), mesh=mesh,
                 block_size=16)
obs.enable()
dbcsr.multiply(a, b, mesh=mesh, algorithm="cannon", densify=False,
               local_kernel="ref", pipeline_depth=1)
obs.disable()
print("JSON" + json.dumps([s.to_dict() for s in obs.last_trace()]))
"""
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    rng = np.random.RandomState(3)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    mask = rng.rand(8, 8) < 0.4
    mask[0, 0] = True
    a = dbcsr.create(rng.randn(128, 128).astype(np.float32), mesh=mesh,
                     block_size=16, block_mask=mask)
    b = dbcsr.create(rng.randn(128, 128).astype(np.float32), mesh=mesh,
                     block_size=16)
    _, spans, _ = _traced(obs, lambda: dbcsr.multiply(
        a, b, mesh=mesh, algorithm="cannon", densify=False,
        local_kernel="ref", pipeline_depth=1))
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-4000:]
    line = [ln for ln in stdout.splitlines() if ln.startswith("JSON")][-1]
    jspans = [obs.SpanRecord.from_dict(d) for d in json.loads(line[4:])]
    assert _tree(spans) == _tree(jspans)
    steps = [s for s in spans if s.cat == "schedule-step"]
    jsteps = [s for s in jspans if s.cat == "schedule-step"]
    for s, js in zip(steps, jsteps):
        assert s.attrs["rank_entries"] == js.attrs["rank_entries"]
        assert s.attrs["comm_bytes"] == js.attrs["comm_bytes"]
    _check_steps_fill_dispatches(spans)
    assert obs.histogram("executor.rank_imbalance").count >= 1


def test_traced_fused_batched_span_tree(rng):
    mesh, jmesh = _mesh11(), jax_make_mesh((1, 1), ("data", "model"))
    both = [(_pair(rng, 64, 64, mesh=mesh, jmesh=jmesh),
             _pair(rng, 64, 64, mesh=mesh, jmesh=jmesh)) for _ in range(3)]
    pairs = [(a, b) for (a, _), (b, _) in both]
    jpairs = [(ja, jb) for (_, ja), (_, jb) in both]
    out, spans, outcomes = _traced(obs, lambda: dbcsr.multiply_batched(
        pairs, mesh=mesh, fused=True, **EXEC_KW))
    _, jspans, jout = _traced(jobs, lambda: jdbcsr.multiply_batched(
        jpairs, mesh=jmesh, fused=True, **EXEC_KW))
    assert _tree(spans) == _tree(jspans)

    (root,) = [s for s in spans if s.parent_id is None]
    assert root.name == "multiply_batched"
    assert root.attrs["n_groups"] == 3
    kids = {s.name: s for s in _children(spans, root)}
    assert set(kids) == {"plan", "dispatch"}
    _check_steps_fill_dispatches(spans)
    assert _spans_by_name(spans, "multiply") == []
    for name in ("batched.requests_fused", "batched.requests_looped",
                 "batched.buckets"):
        assert obs.counter(name).value == jobs.counter(name).value, name
    assert obs.counter("batched.requests_fused").value == 3
    (bout,) = outcomes
    assert bout["kind"] == "multiply_batched" and bout["fuse"] is True
    assert set(bout) == set(jout[0])


def test_traced_looped_batch_roots_are_multiplies(rng):
    mesh = _mesh11()
    pairs = [(_operand(rng, 64, 64, mesh=mesh),
              _operand(rng, 64, 64, mesh=mesh)) for _ in range(2)]
    tracer = obs.enable()
    dbcsr.multiply_batched(pairs, mesh=mesh, fused=False, **EXEC_KW)
    obs.disable()
    roots = [s.name for s in tracer.spans if s.parent_id is None]
    assert roots == ["multiply", "multiply"]
    assert obs.counter("batched.requests_looped").value == 2
    assert [r["kind"] for r in obs.plan_outcomes()] == ["multiply"] * 2


def test_traced_abft_repair_nests_second_dispatch(rng):
    from repro.sparsity.norms import compute_block_norms as jnorms

    mesh, jmesh = _mesh11(), jax_make_mesh((1, 1), ("data", "model"))
    a, ja = _pair(rng, 128, 128, mesh=mesh, jmesh=jmesh)
    b, jb = _pair(rng, 128, 128, mesh=mesh, jmesh=jmesh)
    clean = dbcsr.multiply(a, b, mesh=mesh, **EXEC_KW)
    jclean = jdbcsr.multiply(ja, jb, mesh=jmesh, **EXEC_KW)
    norms = jnorms(jclean.data, 32, 32)
    i0, j0 = (int(x) for x in np.unravel_index(int(np.argmax(norms)),
                                               norms.shape))

    def port():
        hook = chaos.FaultInjector(seed=7).one_shot_result_hook(
            i0, j0, block_m=32, block_n=32, mode="bitflip")
        with chaos.result_corruption(hook):
            return dbcsr.multiply(a, b, mesh=mesh, verify="checksum",
                                  **EXEC_KW)

    def ref():
        hook = jchaos.FaultInjector(seed=7).one_shot_result_hook(
            i0, j0, block_m=32, block_n=32, mode="bitflip")
        with jchaos.result_corruption(hook):
            return jdbcsr.multiply(ja, jb, mesh=jmesh, verify="checksum",
                                   **EXEC_KW)

    cr, spans, outcomes = _traced(obs, port)
    _, jspans, _ = _traced(jobs, ref)
    assert torch.equal(cr.data, clean.data)
    assert _tree(spans) == _tree(jspans)

    (root,) = [s for s in spans if s.parent_id is None]
    (verify,) = _spans_by_name(spans, "verify")
    assert verify.parent_id == root.span_id
    assert verify.attrs == {**verify.attrs, "detected": True,
                            "repaired": True, "n_flagged_blocks": 1}
    (repair,) = _spans_by_name(spans, "repair")
    assert repair.parent_id == verify.span_id
    dispatches = _spans_by_name(spans, "dispatch")
    assert len(dispatches) == 2
    assert sorted(d.parent_id for d in dispatches) == sorted(
        [root.span_id, repair.span_id])
    for name in ("abft.verifications", "abft.detections", "abft.repairs",
                 "abft.repair_failures"):
        assert obs.counter(name).value == jobs.counter(name).value, name
    assert obs.counter("abft.detections").value == 1
    assert obs.counter("abft.repairs").value == 1
    (out,) = outcomes
    first = min(dispatches, key=lambda s: s.t0)
    assert out["measured_s"] == pytest.approx(first.dur, rel=0.25)
    assert obs.validate_chrome_trace(obs.to_chrome_trace(spans)) == []


def test_purification_gauges_mirror_the_trace():
    from repro.sparsity import workloads as jworkloads
    from repro_torch.sparsity.workloads import (banded_hamiltonian,
                                                initial_density,
                                                mcweeny_purify)

    mesh, jmesh = _mesh11(), jax_make_mesh((1, 1), ("data", "model"))
    H, mask = banded_hamiltonian(128, 16, half_bandwidth=3)
    P0h = initial_density(H).astype(np.float32)
    P0 = dbcsr.create(P0h, mesh=mesh, block_size=16, block_mask=mask)
    jP0 = jdbcsr.create(P0h, mesh=jmesh, block_size=16, block_mask=mask)
    kw = dict(densify=False, local_kernel="ref")
    (_, trace), _, _ = _traced(obs, lambda: mcweeny_purify(
        P0, mesh=mesh, n_iter=3, filter_eps=1e-6, multiply_kw=kw))
    _traced(jobs, lambda: jworkloads.mcweeny_purify(
        jP0, mesh=jmesh, n_iter=3, filter_eps=1e-6, multiply_kw=kw))
    occ = obs.gauge("purification.occupancy").samples
    assert occ == [t["occupancy"] for t in trace]
    assert occ == pytest.approx(jobs.gauge("purification.occupancy").samples,
                                abs=1e-12)
    assert obs.gauge("purification.idempotency").samples == pytest.approx(
        jobs.gauge("purification.idempotency").samples, rel=1e-4, abs=1e-4)


# ---------------------------------------------------------------------------
# scoreboard + drift
# ---------------------------------------------------------------------------


def _mk_records():
    return [
        {"algorithm": "cannon", "predicted_s": 1.0, "measured_s": 1.1},
        {"algorithm": "cannon", "predicted_s": 0.9, "measured_s": 1.0},
        {"algorithm": "summa", "predicted_s": 5.0, "measured_s": 1.0},
        {"algorithm": "broken", "predicted_s": 1.0, "measured_s": 0.0},
        {"kind": "contract", "algorithm": "summa", "layout": "(ij|k)@(k|l)",
         "predicted_s": 3e-3, "measured_s": 4e-3},
        {"kind": "multiply_batched", "algorithm": "summa",
         "predicted_s": 2e-3, "measured_s": 1e-3},
    ]


def test_planner_scoreboard_fields():
    sb = obs.planner_scoreboard(_mk_records()[:4])
    assert set(sb) == {"cannon", "summa"}
    assert sb["cannon"]["n"] == 2
    assert sb["cannon"]["rel_err_median"] == pytest.approx(
        (-0.1 / 1.1 - 0.1) / 2.0, abs=1e-12)
    assert sb["summa"]["rel_err_median"] == pytest.approx(4.0)
    assert "cannon" in obs.render_scoreboard(sb)


@pytest.mark.parametrize("n", [4, 6])
def test_scoreboard_and_drift_equal_jax(n):
    records = _mk_records()[:n]
    assert obs.planner_scoreboard(records) == jobs.planner_scoreboard(
        records)
    assert obs.render_scoreboard(obs.planner_scoreboard(records)) == \
        jobs.render_scoreboard(jobs.planner_scoreboard(records))
    for threshold, min_samples in ((1.0, 1), (10.0, 1), (1.0, 2)):
        assert obs.check_drift(records, threshold=threshold,
                               min_samples=min_samples) == jobs.check_drift(
            records, threshold=threshold, min_samples=min_samples)


def test_check_drift_flags_and_min_samples():
    res = obs.check_drift(_mk_records()[:4], threshold=1.0)
    assert not res["ok"] and list(res["flagged"]) == ["summa"]
    ok = obs.check_drift(_mk_records()[:4], threshold=10.0)
    assert ok["ok"] and ok["flagged"] == {}
    res2 = obs.check_drift(_mk_records()[:4], threshold=1.0, min_samples=2)
    assert res2["ok"] and "summa" in res2["scoreboard"]


def test_calibrate_drift_report_reads_log(tmp_path, capsys):
    from repro.planner import calibrate as jcalibrate
    from repro_torch.planner import calibrate

    path = str(tmp_path / "plan_outcomes.jsonl")
    with open(path, "w") as f:
        for r in _mk_records():
            f.write(json.dumps(r) + "\n")
    rep = calibrate.drift_report(path, threshold=1.0)
    assert not rep["ok"] and "summa" in rep["flagged"]
    assert rep["n_records"] == 6 and rep["path"] == path
    assert rep == jcalibrate.drift_report(path, threshold=1.0)
    empty = calibrate.drift_report(str(tmp_path / "nope.jsonl"))
    assert empty["ok"] and empty["n_records"] == 0
    assert calibrate.DEFAULT_PLAN_LOG == jcalibrate.DEFAULT_PLAN_LOG

    # the CLI: no card needed; --strict exits nonzero on drift
    calibrate.main(["--check-drift", "--drift-log", path])
    out = capsys.readouterr().out
    assert "WARNING: summa" in out and "cannon" in out
    with pytest.raises(SystemExit):
        calibrate.main(["--check-drift", "--drift-log", path, "--strict"])
    capsys.readouterr()
    calibrate.main(["--scoreboard", "--drift-log", path])
    out = capsys.readouterr().out
    assert "contract:summa" in out and "WARNING" not in out
    calibrate.main(["--check-drift", "--drift-log",
                    str(tmp_path / "nope.jsonl")])
    assert "no plan outcomes" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# stats() dicts as registry views; executor publishing gated
# ---------------------------------------------------------------------------


def test_plan_cache_stats_is_registry_view():
    from repro_torch.planner.plan import (plan_cache_clear, plan_cache_stats,
                                          plan_multiply)

    plan_cache_clear()
    plan_multiply(256, 256, 256, mesh_shape=(1, 1))
    plan_multiply(256, 256, 256, mesh_shape=(1, 1))
    st = plan_cache_stats()
    assert set(st) == {"hits", "misses", "currsize", "maxsize",
                       "evictions"}
    assert st["hits"] >= 1 and st["misses"] >= 1
    for key, val in st.items():
        assert obs.gauge(f"planner.plan_cache.{key}").value == val


def test_service_stats_is_registry_view(rng):
    from repro_torch.serve.multiply_service import MultiplyService

    mesh = _mesh11()
    svc = MultiplyService(mesh, slo_s=0.0, max_batch=8, **EXEC_KW)
    other = MultiplyService(mesh, slo_s=0.0, max_batch=8, **EXEC_KW)
    assert svc.service_id != other.service_id
    t = [svc.submit(_operand(rng, 64, 64, mesh=mesh),
                    _operand(rng, 64, 64, mesh=mesh)) for _ in range(2)]
    svc.flush()
    for ti in t:
        svc.result(ti)
    st = svc.stats()
    assert st["n_requests"] == 2 and st["n_completed"] == 2
    assert st["latency_p99_s"] >= st["latency_p50_s"] > 0
    assert obs.counter("service.requests",
                       service=svc.service_id).value == 2
    assert obs.counter("service.requests",
                       service=other.service_id).value == 0
    assert other.stats()["n_requests"] == 0
    assert obs.histogram("service.latency_s",
                         service=svc.service_id).count == 2


def test_executor_stats_publish_only_when_enabled():
    from repro.core import engine as jengine
    from repro_torch.core import engine

    obs.clear_metrics()
    p = engine.build_executor_plan(128, 128, 128, 4, 4, 4, 32)
    p.stats()
    assert len(obs.registry()) == 0
    obs.enable()
    st = p.stats()
    obs.disable()
    assert obs.counter("executor.stats_reports").value == 1
    assert obs.counter("executor.entries").value == st["n_entries"]
    assert obs.histogram("executor.occupancy").count == 1
    jp = jengine.build_executor_plan(128, 128, 128, 4, 4, 4, 32)
    jobs.enable()
    jp.stats()
    jobs.disable()
    for name in ("executor.stats_reports", "executor.entries",
                 "executor.padding_triples_saved",
                 "executor.norm_filtered_triples"):
        assert obs.counter(name).value == jobs.counter(name).value, name


def test_batched_and_rank_executor_stats_publish_only_when_enabled():
    from repro_torch.core import engine

    mask = np.eye(4, dtype=bool)
    bp = engine.build_batched_executor_plan(
        128, 128, 128, 32, 32, 32, [{"a_mask": mask}, {}], stack_size=16)
    bp.stats()
    assert len(obs.registry()) == 0
    obs.enable()
    bp.stats()
    obs.disable()
    assert obs.counter("executor.batched_stats_reports").value == 1
    assert obs.histogram("executor.batched_padding_frac").count == 1

    rp = engine.build_rank_executor_plan(
        64, 64, 64, block_m=16, block_k=16, block_n=16,
        rank_masks=[{"a_mask": np.eye(4, dtype=bool)}, {}], stack_size=16)
    obs.clear_metrics()
    rp.stats()
    assert len(obs.registry()) == 0
    obs.enable()
    st = rp.stats()
    obs.disable()
    hist = obs.histogram("executor.rank_imbalance")
    assert hist.count == 1 and hist.sum == st["rank_imbalance"]


# ---------------------------------------------------------------------------
# host ranges on the profiler's clock (obs.ranging)
# ---------------------------------------------------------------------------

# the ranges of one dbcsr.multiply, in start order, and each one's parent
RANGES_BLOCKED = ("multiply", "plan", "local", "dispatch", "pack", "launch",
                  "unpack", "stats", "result_mask")
RANGES_DENSIFIED = ("multiply", "plan", "local", "dispatch", "launch",
                    "stats", "result_mask")
RANGE_PARENT = {"plan": "multiply", "local": "multiply",
                "dispatch": "multiply", "stats": "multiply",
                "pack": "dispatch", "launch": "dispatch",
                "unpack": "dispatch"}


def _profiled(fn):
    """``fn()`` under a CPU ``torch.profiler``: its result and the
    ``dbcsr.*`` ranges recorded, ``[(name, start, end)]`` by start."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = sorted(
        ((e.name[len(obs.RANGE_PREFIX):], e.time_range.start,
          e.time_range.end) for e in prof.events()
         if e.name.startswith(obs.RANGE_PREFIX)), key=lambda r: r[1])
    return out, ranges


def _square_pair(rng, mesh):
    return (_operand(rng, 132, 110, block=22, mesh=mesh),
            _operand(rng, 110, 88, block=22, mesh=mesh))


@pytest.mark.parametrize("densify", [False, True])
def test_profiler_records_each_layer_once_a_call_nested(rng, densify):
    mesh = _mesh11()
    a, b = _square_pair(rng, mesh)
    c, ranges = _profiled(lambda: dbcsr.multiply(a, b, mesh=mesh,
                                                 densify=densify))
    want = RANGES_DENSIFIED if densify else RANGES_BLOCKED
    assert [r[0] for r in ranges] == list(want)
    at = {name: (t0, t1) for name, t0, t1 in ranges}
    for name, parent in RANGE_PARENT.items():
        if name in at:
            assert at[parent][0] <= at[name][0] <= at[name][1] <= \
                at[parent][1], name
    # the result mask follows the multiply it masks
    assert at["multiply"][1] <= at["result_mask"][0]
    assert torch.equal(c.data, dbcsr.multiply(a, b, mesh=mesh,
                                              densify=densify).data)


def test_no_profiler_and_telemetry_off_enters_no_range(rng, monkeypatch):
    from repro_torch.obs import telemetry

    mesh = _mesh11()
    a, b = _square_pair(rng, mesh)
    made = []
    real = telemetry._Range.__init__

    def counting(self, name):
        made.append(name)
        real(self, name)

    monkeypatch.setattr(telemetry._Range, "__init__", counting)
    assert not obs.ranging()
    off = [dbcsr.multiply(a, b, mesh=mesh, densify=d).data
           for d in (False, True)]
    assert made == []
    on, ranges = _profiled(lambda: [dbcsr.multiply(a, b, mesh=mesh,
                                                   densify=d).data
                                    for d in (False, True)])
    assert len(made) == len(ranges) == (len(RANGES_BLOCKED)
                                        + len(RANGES_DENSIFIED))
    for x, y in zip(off, on):
        assert torch.equal(x, y)


def test_profiler_alone_records_no_span_entry_or_outcome(rng):
    mesh = _mesh11()
    mask = np.eye(6, 5, dtype=bool)
    a = dbcsr.create(rng.randn(132, 110).astype(np.float32), mesh=mesh,
                     block_size=22, block_mask=mask)
    b = _operand(rng, 110, 88, block=22, mesh=mesh)
    tracer = obs.get_tracer()
    assert tracer is None and not obs.enabled()
    _, ranges = _profiled(lambda: dbcsr.multiply(
        a, b, mesh=mesh, densify=False, verify="checksum"))
    names = [r[0] for r in ranges]
    assert "verify" in names and "plan" in names
    assert obs.last_trace() == [] and obs.plan_outcomes() == []
    assert len(obs.registry()) == 0


def test_spans_open_their_ranges_and_keep_their_tree(rng):
    mesh = _mesh11()
    a, b = _square_pair(rng, mesh)
    kw = dict(mesh=mesh, **EXEC_KW)
    obs.enable()
    dbcsr.multiply(a, b, **kw)
    plain = _tree(obs.last_trace())
    _, ranges = _profiled(lambda: dbcsr.multiply(a, b, **kw))
    spans = obs.last_trace()
    obs.disable()
    assert _tree(spans) == plain
    names = [r[0] for r in ranges]
    # the spans' own ranges, the layers below them, and the schedule's
    # statistics the span tree reads
    for name in ("multiply", "plan", "dispatch", "local", "pack", "launch",
                 "unpack", "result_mask"):
        assert names.count(name) == 1, name
    assert names.count("stats") == 2


def test_ranges_are_vetoed_under_compile(rng, monkeypatch):
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    mesh = _mesh11()
    a, b = _square_pair(rng, mesh)
    c, ranges = _profiled(lambda: dbcsr.multiply(a, b, mesh=mesh,
                                                 densify=False))
    assert ranges == []
    monkeypatch.undo()
    assert torch.equal(c.data, dbcsr.multiply(a, b, mesh=mesh,
                                              densify=False).data)
