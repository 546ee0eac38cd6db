"""Operational observability: the event log, request tracer, SLO engine,
stall watchdog, perf ledger, flight recorder and host profiler, each a
process-wide singleton (``get_*``) with a reset hook.

``reset_observability`` resets all of them at once. The port's tests call
it before and after each test that builds an engine or a server: the
singletons outlive a test, and state one test leaves (an SLO page that
sheds bulk admissions, a watchdog's marks, stale perf rows, a running
sampler thread) must never reach the next.
"""


def reset_observability() -> None:
    """Reset the port's metrics, tracer, events, SLO engine, watchdog,
    perf ledger and flight recorder in place, and stop the host
    profiler (its sampler thread is joined; the next ``get_profiler``
    reads ``PROF_*`` again)."""
    from fasttalk_tpu_torch.observability.events import reset_events
    from fasttalk_tpu_torch.observability.flight import reset_flight
    from fasttalk_tpu_torch.observability.perf import reset_perf
    from fasttalk_tpu_torch.observability.profiler import reset_profiler
    from fasttalk_tpu_torch.observability.slo import reset_slo
    from fasttalk_tpu_torch.observability.trace import reset_tracer
    from fasttalk_tpu_torch.observability.watchdog import reset_watchdog
    from fasttalk_tpu_torch.utils.metrics import reset_metrics

    reset_metrics()
    reset_tracer()
    reset_events()
    reset_slo()
    reset_watchdog()
    reset_perf()
    reset_flight()
    reset_profiler()
