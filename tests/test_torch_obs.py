"""The port's ``repro_torch.obs`` against the reference's ``repro.obs``: the
same calls give the same Chrome-trace structure and the same Prometheus
text, disabled spans are the shared no-op, the report CLI reads both
artifacts, and the kernel layer's spans carry the reference's names.
"""

import functools
import io
import json
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import gspn2_vision as jconfigs
from repro.models import vision as jvision
from repro.obs import report as jreport
from repro_torch import obs
from repro_torch.configs import gspn2_vision as configs
from repro_torch.models import vision
from repro_torch.models.convert import vision_state_from_jax
from repro_torch.obs import report

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def fresh():
    """Both packages with tracing off, an empty ring and an empty
    registry, before and after the test."""
    def reset():
        for m in (obs, jobs):
            m.disable()
            m.clear()
            m.REGISTRY.reset()
    reset()
    yield
    reset()


def _drive(m):
    """One fixed sequence of tracing and metric calls on package ``m``."""
    m.enable(ring=64)
    with m.trace("serve.decode_step", batch=4) as sp:
        with m.trace("kernel.launch", kernel="gspn_pair_fwd", g=8):
            pass
        sp.set(plan="fwd")
    m.event("train.loss_scale", scale=2048.0)
    m.async_begin("request", 7, prompt=3)
    m.async_end("request", 7, tokens=5)
    m.disable()
    with m.trace("never.recorded"):
        pass
    m.counter("steps_total", help="steps").inc(3)
    m.gauge("queue_depth").set(2.5)
    h = m.histogram("ttft_seconds", help="time to first token")
    for v in (0.0001, 0.003, 0.2, 11.0):
        h.observe(v)
    m.histogram("batch", buckets=m.DEPTH_BUCKETS).observe(3)


def _structure(trace):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid", "tid")}
            for e in trace["traceEvents"]]


def test_same_calls_give_same_trace_and_metrics(fresh):
    _drive(obs)
    _drive(jobs)
    mine, theirs = obs.chrome_trace(), jobs.chrome_trace()
    assert _structure(mine) == _structure(theirs)
    assert [e["name"] for e in mine["traceEvents"]] == [
        "kernel.launch", "serve.decode_step", "train.loss_scale", "request",
        "request"]
    assert mine["displayTimeUnit"] == theirs["displayTimeUnit"]
    assert obs.prometheus() == jobs.prometheus()
    assert obs.snapshot() == jobs.snapshot()
    assert obs.LATENCY_BUCKETS == jobs.LATENCY_BUCKETS
    assert obs.DEPTH_BUCKETS == jobs.DEPTH_BUCKETS
    assert obs.monotonic is jobs.monotonic


def test_disabled_spans_are_the_noop_singleton(fresh):
    assert not obs.enabled()
    assert obs.trace("kernel.launch", g=1) is obs.NOOP_SPAN
    assert obs.trace("x").set(a=1) is obs.NOOP_SPAN
    obs.event("e")
    obs.async_begin("r", 1)
    assert obs.records() == []
    obs.enable()
    assert isinstance(obs.trace("kernel.launch"), obs.Span)


def test_enabled_span_enters_a_profiler_record(fresh):
    obs.enable()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.trace("kernel.dispatch", op="gspn_scan_pair"):
            torch.ones(2) + 1
    assert "kernel.dispatch" in {e.key for e in prof.key_averages()}


def test_report_cli_summarises_both_artifacts(fresh, tmp_path):
    _drive(obs)
    _drive(jobs)
    trace = obs.save_chrome_trace(tmp_path / "trace.json")
    metrics = obs.save_metrics(tmp_path / "metrics.json")
    prom = obs.save_metrics(tmp_path / "metrics.prom")
    assert pathlib.Path(prom).read_text() == jobs.prometheus()
    assert json.loads(pathlib.Path(metrics).read_text()) == jobs.snapshot()
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys; from repro_torch.obs import report; "
         "sys.exit(report.main([sys.argv[1]]) or report.main([sys.argv[2]]))",
         trace, metrics],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "trace: 5 events (2 spans, 2 async, 1 instant)" in res.stdout
    assert "ttft_seconds" in res.stdout and "steps_total" in res.stdout
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", str(trace)],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "serve.decode_step" in res.stdout
    mine, theirs = io.StringIO(), io.StringIO()
    payload = json.loads(pathlib.Path(metrics).read_text())
    report.summarize_metrics(payload, out=mine)
    jreport.summarize_metrics(payload, out=theirs)
    assert mine.getvalue() == theirs.getvalue()
    assert report.main([str(tmp_path / "missing.json")]) == 1


def test_importing_the_port_obs_loads_no_jax():
    code = ("import sys, repro_torch.obs, repro_torch.obs.report, "
            "repro_torch.kernels.ops; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


def _dispatches(m, impl_names=None):
    return {(r.args["op"], (impl_names or {}).get(r.args["impl"],
                                                  r.args["impl"]),
             r.args["dtype"], r.args["shape"])
            for r in m.spans("kernel.dispatch")}


def test_vision_forward_records_the_reference_dispatch_spans(fresh):
    """A CPU pass of the reduced vision forward with tracing on: the port
    records one ``kernel.dispatch`` span per pair dispatch with the
    reference's op name, dtype and operand shapes (the reference's
    ``xla`` leg is the port's ``torch``); the reference traces each
    stage's block body once under ``lax.scan``."""
    jcfg = jconfigs.reduced_vision()
    params = jax.jit(functools.partial(jvision.init_vision, cfg=jcfg))(
        jax.random.PRNGKey(0))
    model = vision.GSPNVision(configs.reduced_vision(), device="cpu")
    model.load_state_dict(vision_state_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    x = np.random.default_rng(0).standard_normal(
        (2, jcfg.img_size, jcfg.img_size, 3)).astype(np.float32)

    jobs.enable()
    jvision.apply_vision(params, x, jcfg)
    jobs.disable()
    obs.enable()
    vision.apply_vision(model, torch.from_numpy(x))
    obs.disable()

    mine = _dispatches(obs)
    assert mine == _dispatches(jobs, {"xla": "torch"})
    assert {op for op, *_ in mine} == {"gspn_scan_pair"}
    cfg = configs.reduced_vision()
    assert len(obs.spans("kernel.dispatch")) == 2 * sum(cfg.depths)
    assert obs.spans("kernel.launch") == []       # no kernel on the CPU
