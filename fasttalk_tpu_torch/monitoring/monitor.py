"""Monitoring endpoints on a dedicated port.

The port's rewrite of ``fasttalk_tpu/monitoring/monitor.py``: a second
aiohttp app in the serving event loop, backed by the process-wide
metrics registry and observability singletons, with every route of the
JAX app (:503-521):

- ``/health`` (host CPU and memory, the scheduler's overload state, the
  watchdog, the SLO burn state, the supervisor's restart budget, which
  reads ``dead`` once exhausted, and a warning while fault injection is
  armed), ``/health/ready``, ``/health/live``;
- ``/slo``, ``/perf``, ``/events``, ``/metrics`` (Prometheus text; the
  heartbeat-age and ``perf_*`` gauges refreshed at scrape time),
  ``/metrics.json``, ``/info``;
- ``POST /debug/bundle`` (a flight-recorder bundle), ``/debug/profile``
  (the host stack sampler), ``/debug/requests`` (in-flight and queued
  requests), ``GET /debug/fault`` (the failpoint catalog and the armed
  rules, always served) and ``POST /debug/fault`` (arm a spec or clear
  it), which answers 403 unless ``FAULT_HTTP`` is on;
- ``/traces`` (the completed-trace ring; ``?format=chrome|jsonl``) and
  ``/traces/{request_id}``;
- ``POST /profiler/start`` and ``POST /profiler/stop``: a
  ``torch.profiler`` capture (CPU, and CUDA kernels on the card) written
  as a Chrome trace, ``trace.json``, under ``PROFILER_TRACE_DIR``
  (default ``/tmp/fasttalk-tpu-torch-trace``, the port's own); the body
  may only name a subdirectory of it. ``GET /profiler/memory`` reads
  ``torch.cuda.memory_stats`` for each card (an empty list on the CPU).

The profiler runs on one worker thread of the app (start and stop on the
same thread), which the app's cleanup stops.
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import torch
from aiohttp import web

from fasttalk_tpu_torch import __version__
from fasttalk_tpu_torch.observability.events import get_events
from fasttalk_tpu_torch.observability.export import chrome_trace, jsonl_dump
from fasttalk_tpu_torch.observability.flight import get_flight
from fasttalk_tpu_torch.observability.perf import get_perf
from fasttalk_tpu_torch.observability.profiler import get_profiler
from fasttalk_tpu_torch.observability.slo import get_slo
from fasttalk_tpu_torch.observability.trace import get_tracer
from fasttalk_tpu_torch.observability.watchdog import get_watchdog
from fasttalk_tpu_torch.resilience import failpoints
from fasttalk_tpu_torch.utils.metrics import get_metrics

DEFAULT_TRACE_DIR = "/tmp/fasttalk-tpu-torch-trace"


def _device_memory() -> list[dict]:
    """Allocator statistics of each CUDA device ([] without one)."""
    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i}",
            "platform": "gpu",
            "name": torch.cuda.get_device_name(i),
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "bytes_reserved": stats.get("reserved_bytes.all.current"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
        })
    return out


def _system() -> dict[str, Any]:
    """Host CPU and memory (psutil); the error when it cannot be read."""
    try:
        import psutil
    except ImportError as e:
        return {"error": f"host statistics unavailable: {e}"}
    mem = psutil.virtual_memory()
    return {"cpu_percent": psutil.cpu_percent(interval=0),
            "memory_percent": mem.percent,
            "memory_available_gb": mem.available / (1024 ** 3)}


def build_monitoring_app(ready_check=None, sched_info=None,
                         supervisor_info=None, fault_http=False,
                         ) -> web.Application:
    """``ready_check``: zero-arg callable, False makes ``/health/ready``
    503. ``sched_info``: zero-arg callable returning the engine's
    scheduler view (``TorchEngine.scheduler_debug``) for ``/health`` and
    ``/debug/requests``. ``supervisor_info``: zero-arg callable returning
    the launcher's restart-budget state; "exhausted" marks ``/health``
    dead. ``fault_http``: serve ``POST /debug/fault`` (off by default: the
    monitoring port is unauthenticated)."""
    app = web.Application()
    # One worker thread owns the torch.profiler session: started and
    # stopped there, off the serving event loop.
    pool = ThreadPoolExecutor(max_workers=1,
                              thread_name_prefix="monitor-profiler")
    prof_state: dict[str, Any] = {"active": False, "log_dir": None,
                                  "started_at": None, "prof": None}

    async def on_cleanup(app: web.Application) -> None:
        if prof_state["active"]:
            prof_state["active"] = False
            await asyncio.get_running_loop().run_in_executor(
                pool, prof_state["prof"].stop)
        pool.shutdown(wait=True)

    app.on_cleanup.append(on_cleanup)

    def _sched_view() -> dict | None:
        if sched_info is None:
            return None
        try:
            return sched_info()
        except Exception:
            return None

    async def health(request: web.Request) -> web.Response:
        m = get_metrics()
        system = _system()
        body: dict[str, Any] = {
            "status": "healthy",
            "uptime_seconds": m.uptime(),
            "system": system,
            "metrics": m.to_dict(),
        }
        warnings = []
        if "error" in system:
            warnings.append(system["error"])
        else:
            if system["cpu_percent"] > 90:
                warnings.append("High CPU usage")
            if system["memory_percent"] > 90:
                warnings.append("High memory usage")
        sched = _sched_view()
        if sched is not None:
            body["scheduler"] = sched.get("stats")
            state = (sched.get("stats") or {}).get("state")
            if state and state != "healthy":
                body["status"] = state
                warnings.append(f"Admission control {state}")
        wd = get_watchdog().status()
        body["watchdog"] = wd
        if not wd["ok"]:
            body["status"] = "degraded"
            if wd["step_stalled"]:
                warnings.append(
                    f"Engine step loop stalled "
                    f"(heartbeat {wd['heartbeat_age_s']}s old)")
            for rid in wd["token_stalled"]:
                warnings.append(f"Request {rid} token-stalled")
        slo = get_slo().alert_summary()
        if slo:
            body["slo"] = slo
            for cls, state in slo.items():
                if state == "page":
                    body["status"] = "degraded"
                if state != "ok":
                    warnings.append(f"SLO burn {state} for {cls}")
        # An exhausted restart budget: the engine is down and will not be
        # restarted again.
        if supervisor_info is not None:
            try:
                sup = supervisor_info()
            except Exception:
                sup = None
            if sup is not None:
                body["supervisor"] = sup
                if sup.get("state") == "exhausted":
                    body["status"] = "dead"
                    warnings.append(
                        "Supervisor restart budget exhausted; engine "
                        "will not be restarted (restart the process)")
        if failpoints.enabled:
            body["fault_injection"] = {
                "active_points": failpoints.active_points()}
            warnings.append("Fault injection ACTIVE "
                            "(see GET /debug/fault)")
        if warnings:
            body["warnings"] = warnings
        return web.json_response(body)

    async def ready(request: web.Request) -> web.Response:
        if ready_check is not None and not ready_check():
            return web.json_response({"status": "not_ready"}, status=503)
        return web.json_response({"status": "ready"})

    async def live(request: web.Request) -> web.Response:
        return web.json_response({"status": "live"})

    async def metrics(request: web.Request) -> web.Response:
        # Scrape-time samples: the heartbeat age and the perf_* gauges.
        get_watchdog().sample()
        get_perf().sample()
        return web.Response(text=get_metrics().prometheus(),
                            content_type="text/plain")

    async def metrics_json(request: web.Request) -> web.Response:
        return web.json_response(get_metrics().to_dict())

    async def info(request: web.Request) -> web.Response:
        return web.json_response({
            "service": "fasttalk-tpu-torch",
            "version": __version__,
            "uptime_seconds": get_metrics().uptime(),
        })

    async def profiler_start(request: web.Request) -> web.Response:
        from torch.profiler import ProfilerActivity, profile

        body = {}
        if request.can_read_body:
            try:
                body = await request.json()
            except json.JSONDecodeError:
                pass
        # The port is unauthenticated: traces go under a fixed base and
        # the body may only name a subdirectory within it.
        base = os.path.realpath(os.environ.get("PROFILER_TRACE_DIR",
                                               DEFAULT_TRACE_DIR))
        sub = str(body.get("log_dir", ""))
        if os.path.isabs(sub):
            return web.json_response(
                {"error": "log_dir must be a relative subdirectory of "
                 f"{base} (set PROFILER_TRACE_DIR to move the base)"},
                status=400)
        log_dir = os.path.realpath(os.path.join(base, sub)) if sub else base
        if log_dir != base and not log_dir.startswith(base + os.sep):
            return web.json_response(
                {"error": "log_dir must be a relative subdirectory of "
                 f"{base}"}, status=400)
        # Check and claim with no await between them.
        if prof_state["active"]:
            return web.json_response(
                {"error": "trace already active",
                 "log_dir": prof_state["log_dir"]}, status=409)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof_state.update(active=True, log_dir=log_dir,
                          started_at=time.monotonic(), prof=prof)
        try:
            await asyncio.get_running_loop().run_in_executor(pool,
                                                             prof.start)
        except Exception as e:
            prof_state.update(active=False, log_dir=None, started_at=None,
                              prof=None)
            return web.json_response({"error": str(e)}, status=500)
        return web.json_response({"status": "tracing", "log_dir": log_dir})

    async def profiler_stop(request: web.Request) -> web.Response:
        if not prof_state["active"]:
            return web.json_response({"error": "no active trace"},
                                     status=409)
        duration = time.monotonic() - (prof_state["started_at"] or 0)
        log_dir, prof = prof_state["log_dir"], prof_state["prof"]
        # Release the claim before the awaited stop: a concurrent stop
        # gets a clean 409.
        prof_state.update(active=False, log_dir=None, started_at=None,
                          prof=None)
        path = os.path.join(log_dir, "trace.json")

        def stop_and_write() -> None:
            prof.stop()
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(path)

        try:
            await asyncio.get_running_loop().run_in_executor(
                pool, stop_and_write)
        except Exception as e:
            return web.json_response({"error": str(e)}, status=500)
        return web.json_response({"status": "stopped", "log_dir": log_dir,
                                  "trace": path,
                                  "duration_seconds": duration})

    async def profiler_memory(request: web.Request) -> web.Response:
        return web.json_response({"devices": _device_memory()})

    async def _render_off_loop(build) -> str:
        """Build and encode an export on a worker thread: a full ring is
        large, and this loop also serves every token stream."""
        return await asyncio.get_running_loop().run_in_executor(
            None, lambda: json.dumps(build()))

    async def debug_requests(request: web.Request) -> web.Response:
        """In-flight requests with phase and age; queued ones with their
        admission position, priority and remaining deadline."""
        tracer = get_tracer()
        body: dict[str, Any] = {
            "enabled": tracer.enabled,
            "requests": tracer.inflight_summary(),
        }
        sched = _sched_view()
        if sched is not None:
            body["scheduler"] = sched.get("stats")
            queued = {q["request_id"]: q for q in sched.get("queued", [])}
            for r in body["requests"]:
                extra = queued.pop(r["request_id"], None)
                if extra is not None:
                    r.update(queue_position=extra["position"],
                             priority=extra["priority"],
                             deadline_in_s=extra["deadline_in_s"])
            body["queued_untraced"] = list(queued.values())
            if sched.get("parked_sessions") is not None:
                body["kv_host"] = sched.get("kv_host")
                body["parked_sessions"] = sched["parked_sessions"]
        return web.json_response(body)

    async def traces_index(request: web.Request) -> web.Response:
        """The completed-trace ring: an index, or ?format=chrome (a
        Chrome trace of the ring and the engine-step row) or
        ?format=jsonl (the flat records)."""
        tracer = get_tracer()
        fmt = request.query.get("format", "")
        completed = tracer.completed()
        if fmt == "chrome":
            text = await _render_off_loop(
                lambda: chrome_trace(tracer, completed, tracer.steps()))
            return web.Response(text=text, content_type="application/json")
        if fmt == "jsonl":
            text = await asyncio.get_running_loop().run_in_executor(
                None, jsonl_dump, tracer, completed, tracer.steps())
            return web.Response(text=text,
                                content_type="application/x-ndjson")
        if fmt:
            return web.json_response(
                {"error": f"unknown format {fmt!r} "
                 "(expected chrome or jsonl)"}, status=400)
        return web.json_response({
            "enabled": tracer.enabled,
            "completed": [t.request_id for t in completed],
            "inflight": [t["request_id"] for t in tracer.inflight_summary()],
            "engine_steps": len(tracer.steps()),
        })

    async def trace_one(request: web.Request) -> web.Response:
        """One request's trace: a Chrome trace, or ?format=jsonl."""
        rid = request.match_info["request_id"]
        tracer = get_tracer()
        trace = tracer.get(rid)
        if trace is None:
            return web.json_response(
                {"error": f"unknown request_id {rid!r}"}, status=404)
        if request.query.get("format") == "jsonl":
            text = await asyncio.get_running_loop().run_in_executor(
                None, jsonl_dump, tracer, [trace])
            return web.Response(text=text,
                                content_type="application/x-ndjson")
        text = await _render_off_loop(lambda: chrome_trace(tracer, [trace]))
        return web.Response(text=text, content_type="application/json")

    async def perf(request: web.Request) -> web.Response:
        """The attribution report (observability/perf.py)."""
        return web.json_response(
            await asyncio.to_thread(get_perf().report))

    async def debug_profile(request: web.Request) -> web.Response:
        """The host stack sampler: flamegraph-collapsed text, or
        ?format=json for the structured report."""
        prof = get_profiler()
        if request.query.get("format") == "json":
            return web.json_response(prof.report())
        if not prof.enabled:
            return web.Response(
                text="# continuous profiler disabled "
                     "(PROF_ENABLED=false)\n",
                content_type="text/plain", status=200)
        text = await asyncio.get_running_loop().run_in_executor(
            None, prof.collapsed)
        return web.Response(text=text, content_type="text/plain")

    async def debug_bundle(request: web.Request) -> web.Response:
        """Capture a flight-recorder bundle now (bypasses the rate limit,
        not the one-writer-at-a-time guard)."""
        flight = get_flight()
        if not flight.enabled:
            return web.json_response(
                {"error": "flight recorder disabled "
                 "(FLIGHT_ENABLED=0)"}, status=409)
        path = flight.trigger("manual", force=True)
        if path is None:
            return web.json_response(
                {"error": "a bundle write is already in progress",
                 **flight.stats()}, status=429)
        return web.json_response({**flight.stats(),
                                  "status": "writing", "dir": path})

    async def fault_get(request: web.Request) -> web.Response:
        """The failpoint catalog and active rules (read-only)."""
        return web.json_response(failpoints.describe())

    async def fault_post(request: web.Request) -> web.Response:
        """Arm a fault-injection spec (replacing the armed set) or clear
        it: {"spec": "..."} | {"clear": true}. Gated by FAULT_HTTP."""
        if not fault_http:
            return web.json_response(
                {"error": "fault-injection HTTP control is disabled "
                 "(set FAULT_HTTP=true; never in production)"},
                status=403)
        try:
            body = await request.json()
        except Exception:
            return web.json_response(
                {"error": "body must be JSON: {\"spec\": \"...\"} or "
                 "{\"clear\": true}"}, status=400)
        if body.get("clear"):
            failpoints.clear()
            return web.json_response(failpoints.describe())
        spec = body.get("spec")
        if not isinstance(spec, str) or not spec.strip():
            return web.json_response(
                {"error": "missing \"spec\" (failpoint spec string) "
                 "or \"clear\": true"}, status=400)
        try:
            failpoints.activate(spec)
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=400)
        return web.json_response(failpoints.describe())

    async def slo(request: web.Request) -> web.Response:
        """Per-class SLO report (observability/slo.py)."""
        return web.json_response(get_slo().snapshot())

    async def events(request: web.Request) -> web.Response:
        """Newest-first structured events (?limit=N, ?kind=...,
        ?min_severity=warning|critical)."""
        try:
            limit = int(request.query.get("limit", "100"))
        except ValueError:
            return web.json_response(
                {"error": "limit must be an integer"}, status=400)
        log_ = get_events()
        return web.json_response({
            "events": log_.recent(
                limit=limit,
                kind=request.query.get("kind") or None,
                min_severity=request.query.get("min_severity") or None),
            "total_emitted": log_.total_emitted,
            "ring_size": log_.ring_size,
        })

    app.router.add_get("/health", health)
    app.router.add_get("/health/ready", ready)
    app.router.add_get("/health/live", live)
    app.router.add_get("/slo", slo)
    app.router.add_get("/perf", perf)
    app.router.add_post("/debug/bundle", debug_bundle)
    app.router.add_get("/debug/profile", debug_profile)
    app.router.add_get("/debug/fault", fault_get)
    app.router.add_post("/debug/fault", fault_post)
    app.router.add_get("/events", events)
    app.router.add_get("/metrics", metrics)
    app.router.add_get("/metrics.json", metrics_json)
    app.router.add_get("/info", info)
    app.router.add_post("/profiler/start", profiler_start)
    app.router.add_post("/profiler/stop", profiler_stop)
    app.router.add_get("/profiler/memory", profiler_memory)
    app.router.add_get("/debug/requests", debug_requests)
    app.router.add_get("/traces", traces_index)
    app.router.add_get("/traces/{request_id}", trace_one)
    return app
