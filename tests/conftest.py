"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests must see ONE
CPU device; multi-device tests go through the ``run_sub`` fixture, which
spawns subprocesses with their own flags (the device count must be forced
BEFORE jax import, so it cannot be done in-process)."""

import ast
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

# Prepended to every ``run_sub`` body: 8 fake CPU devices + the compat
# mesh helpers (jax.sharding.AxisType / jax.set_mesh moved across jax
# releases; repro.compat papers over both).
SUB_PRELUDE = textwrap.dedent("""
    import os
    # APPENDED so it wins: on duplicated XLA flags the LAST occurrence
    # applies, and the inherited env may already force a device count
    # (importing repro.launch.dryrun in the pytest parent sets 512).
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    import jax, jax.numpy as jnp, numpy as np
    from repro.compat import make_mesh, set_mesh, shard_map
""")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "kernels: interpret-mode Pallas kernel validation "
        "(cheap PR gate: pytest -m kernels)")
    config.addinivalue_line(
        "markers",
        "distributed: multi-device behaviour on 8 forced host-platform CPU "
        "devices in subprocesses — no TPUs needed (pytest -m distributed)")
    config.addinivalue_line(
        "markers",
        "serve: continuous-batching engine / chunked-prefill / cache-pool "
        "tests on tiny configs (pytest -m serve)")
    config.addinivalue_line(
        "markers",
        "bench: benchmark --json schema and perf-regression-gate tests "
        "(pytest -m bench)")
    config.addinivalue_line(
        "markers",
        "obs: tracing/metrics subsystem + instrumentation contracts, "
        "including the disabled-overhead pin (pytest -m obs)")
    config.addinivalue_line(
        "markers",
        "cuda: PyTorch port kernel tests that need a CUDA card and nvcc; "
        "they skip without one (pytest -m cuda tests/test_torch_cuda.py)")


@pytest.fixture(scope="session", autouse=True)
def _single_device_guard():
    assert len(jax.devices()) == 1, (
        "tests must run on a single device; the dry-run sets its own flags")
    yield


@pytest.fixture(scope="session")
def run_sub():
    """Run a python test body on 8 fake CPU devices in a subprocess.

    Subprocess-or-skip: a one-time probe checks that this interpreter can
    spawn subprocesses AND that the host-platform device-count flag takes
    effect (it does not on real TPU backends); otherwise every dependent
    test skips instead of failing on CI hardware without TPUs.
    """
    try:
        probe = subprocess.run(
            [sys.executable, "-c",
             SUB_PRELUDE + "assert jax.device_count() == 8"],
            capture_output=True, text=True, timeout=240)
        ok, why = probe.returncode == 0, probe.stderr.strip()[-400:]
    except (OSError, subprocess.SubprocessError) as exc:  # no subprocesses
        ok, why = False, repr(exc)
    if not ok:
        pytest.skip(f"8-device host-platform subprocess unavailable: {why}")

    def run(body: str, timeout: int = 560):
        dedented = textwrap.dedent(body)
        # Guard against the silent-no-op failure mode: when a shared
        # setup string is indented shallower than the test body, dedent
        # strips only the common prefix and the body's statements end up
        # NESTED inside the last setup def — syntactically valid, never
        # executed, subprocess exits 0.  A real body always has at least
        # one top-level statement that is not an import or a definition.
        tree = ast.parse(dedented)
        assert any(not isinstance(n, (ast.Import, ast.ImportFrom,
                                      ast.FunctionDef, ast.ClassDef))
                   for n in tree.body), (
            "run_sub body has no top-level executable statements — "
            "shared setup string indented shallower than the body?")
        script = SUB_PRELUDE + dedented
        r = subprocess.run([sys.executable, "-c", script],
                           capture_output=True, text=True, timeout=timeout,
                           env=None)
        assert r.returncode == 0, \
            f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
        return r.stdout

    return run


@pytest.fixture
def rng():
    return np.random.default_rng(0)
