"""The autouse fixture of every ``tests/test_torch_*.py`` file that builds
a port engine or server (import it into the test module).

The port's observability singletons (metrics, tracer, events, SLO engine,
watchdog, perf ledger, flight recorder, host profiler) are process-wide
and ``tests/conftest.py`` resets only the JAX package's, so each test
starts and ends with ``reset_observability()``. So is the port's
failpoint registry (resilience/failpoints.py): a rule a chaos test left
armed would fire in whichever port test runs next in the process, so the
fixture clears it on both sides. The host sampler is off
(``PROF_ENABLED=false``; a test about the profiler turns it on with
``monkeypatch``), and flight bundles and profiler traces go under the
test's ``tmp_path``.
"""

import pytest


@pytest.fixture(autouse=True)
def port_isolation(monkeypatch, tmp_path):
    from fasttalk_tpu_torch.observability import reset_observability
    from fasttalk_tpu_torch.resilience import failpoints

    monkeypatch.setenv("PROF_ENABLED", "false")
    monkeypatch.setenv("FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("PROFILER_TRACE_DIR", str(tmp_path / "trace"))
    failpoints.clear()
    reset_observability()
    yield
    failpoints.clear()
    reset_observability()
