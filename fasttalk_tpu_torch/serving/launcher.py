"""Service lifecycle: build the engine, verify it, serve, shut down cleanly.

The port's counterpart of ``fasttalk_tpu/serving/launcher.py``.
``python -m fasttalk_tpu_torch websocket`` runs
``ServerLauncher(Config()).start()``, or with ``TPU_SPMD_ROLE=follower``
``run_spmd_follower`` (no gateway: the rank replays the leader's device
calls). With ``TPU_SPMD_ROLE=leader`` the engine publishes every device
call to a ``CallBroadcaster`` its followers connect to, warmup is forced
off (its calls are not replicated), a dead engine thread or a dead
cluster brings the gateway down for a cluster restart instead of an
in-place restart, and the broadcaster closes after the engine (JAX
:40-60, :118-134, :226-239, :356-360). Otherwise:

- the engine from ``build_engine`` (``LLM_PROVIDER`` picks the in-tree
  engine, the fake one or a remote provider), or with ``ROUTER_ENABLED``
  a ``FleetRouter`` over ``FLEET_REPLICAS`` in-process engines and the
  ``ROUTER_BACKENDS`` remote ones (``build_fleet``, router/router.py);
  with ``FLEET_SCALE_MAX`` > 0 an ``ElasticScaler`` (router/elastic.py)
  grows and shrinks that fleet while the server runs. The tool-calling
  agent goes around the engine or the router from ``build_agent`` when
  ``ENABLE_PYDANTIC_AI`` and ``ENABLE_TOOLS`` are both true (the
  default). The agent is built here and in serving/local.py only, never
  by the server or the factory;
- ``verify_backend``: ``warmup(TPU_WARMUP)``, ``start()`` and the
  pre-flight connection check;
- the WebSocket server and the monitoring app (its ``/health`` reads the
  supervisor's state, ``POST /debug/fault`` is gated by ``FAULT_HTTP``) in
  one event loop, SIGINT/SIGTERM through the loop;
- the supervisor (``_watchdog``): a dead engine thread is restarted with
  ``engine.restart()`` under a ``RestartBudget`` (``SUPERVISOR_*``);
  restarts count in ``engine_restarts_total``, and an exhausted budget
  reads ``dead`` on ``/health`` and never restarts again;
- on shutdown the server drains, both apps stop, the agent's resources are
  released (``aclose``) and the engine shuts down.
"""

from __future__ import annotations

import asyncio
import signal
import time
from typing import Any

import torch
from aiohttp import web

from fasttalk_tpu_torch.engine.engine import EngineBase
from fasttalk_tpu_torch.engine.factory import build_engine
from fasttalk_tpu_torch.monitoring.monitor import build_monitoring_app
from fasttalk_tpu_torch.observability.events import get_events
from fasttalk_tpu_torch.serving.server import WebSocketLLMServer
from fasttalk_tpu_torch.utils.config import Config
from fasttalk_tpu_torch.utils.errors import LLMServiceError
from fasttalk_tpu_torch.utils.logger import get_logger
from fasttalk_tpu_torch.utils.metrics import get_metrics

log = get_logger("serving.launcher")


def run_spmd_follower(config: Config,
                      device: str | torch.device | None = None) -> int:
    """Multi-rank SPMD serving, follower role (``TPU_SPMD_ROLE=follower``):
    build the identical engine over the mesh and replay the leader's
    device-call stream against this rank's shards. No gateway, no engine
    thread: the leader is the cluster's only decision-maker
    (parallel/spmd_serving.py). Returns 0 after the leader's stop frame;
    a dead leader or an abort frame raises."""
    from fasttalk_tpu_torch.parallel.spmd_serving import follower_loop

    engine = build_engine(config, device=device)
    host, port = config.spmd_addr.rsplit(":", 1)
    log.info(f"SPMD follower: replaying leader calls from {host}:{port}")
    follower_loop(engine, host, int(port),
                  hb_timeout_s=config.spmd_hb_timeout_s)
    return 0


def build_agent(config: Config, engine: EngineBase):
    """The tool-calling agent when enabled (None otherwise)."""
    if not (config.enable_agent and config.enable_tools):
        return None
    from fasttalk_tpu_torch.agents.voice_agent import VoiceAgent

    return VoiceAgent(engine, config)


class RestartBudget:
    """Supervisor restart-storm guard: at most ``max_restarts`` restarts per
    rolling window, with exponential backoff between attempts. Exhaustion
    latches: ``/health`` reads dead and the supervisor stops resurrecting
    the engine (a device state poisoned for good must not crash-loop).
    The clock is injectable for tests."""

    def __init__(self, max_restarts: int = 5, window_s: float = 300.0,
                 backoff_s: float = 2.0, backoff_cap_s: float = 60.0,
                 clock=None):
        self.max_restarts = max(1, max_restarts)
        self.window_s = window_s
        self.backoff_s = backoff_s
        self.backoff_cap_s = backoff_cap_s
        self._clock = clock if clock is not None else time.monotonic
        self._attempts: list[float] = []  # timestamps inside the window
        self.exhausted = False

    def _prune(self) -> None:
        cutoff = self._clock() - self.window_s
        self._attempts = [t for t in self._attempts if t >= cutoff]

    def allow(self) -> bool:
        """May another restart be attempted now? Once exhausted, never
        again (flapping back on window expiry would be the same crash loop
        at a slower cadence)."""
        if self.exhausted:
            return False
        self._prune()
        if len(self._attempts) >= self.max_restarts:
            self.exhausted = True
            return False
        return True

    def note_attempt(self) -> float:
        """Record one attempt; returns the delay before the next one
        (exponential in the in-window attempt count, capped)."""
        self._prune()
        self._attempts.append(self._clock())
        n = len(self._attempts)
        return min(self.backoff_cap_s, self.backoff_s * (2 ** (n - 1)))

    def state(self) -> dict:
        self._prune()
        return {
            "state": "exhausted" if self.exhausted else "ok",
            "restarts_in_window": len(self._attempts),
            "max_restarts": self.max_restarts,
            "window_s": self.window_s,
        }


class ServerLauncher:
    """``device``: where ``build_engine`` puts the in-tree engine, or each
    in-process replica of a fleet (``cuda`` unless the caller asks for the
    CPU). ``watchdog_interval_s``: the supervisor's check period."""

    def __init__(self, config: Config, engine: EngineBase | None = None, *,
                 device: str | torch.device | None = None,
                 watchdog_interval_s: float = 5.0):
        self.config = config
        self.device = device
        self._spmd_sink = None
        if config.spmd_role == "leader" and engine is None:
            # Followers replay every serving-time device call, so the sink
            # attaches before any traffic, and warmup (not published) is
            # off for the whole cluster.
            from fasttalk_tpu_torch.parallel.spmd_serving import \
                CallBroadcaster

            if config.warmup not in ("off", "", "none"):
                log.info("SPMD leader: forcing TPU_WARMUP=off "
                         "(warmup calls are not replicated)")
                config.warmup = "off"
            engine = build_engine(config, device=device)
            host, port = config.spmd_addr.rsplit(":", 1)
            self._spmd_sink = CallBroadcaster(
                host, int(port), config.spmd_followers,
                hb_interval_s=config.spmd_hb_interval_s)
            engine.call_sink = self._spmd_sink
        if engine is None and config.router_enabled:
            # Router-backed mode: the "engine" is a FleetRouter fronting N
            # replicas; the serving stack above speaks the same seam.
            from fasttalk_tpu_torch.router.router import build_fleet

            engine = build_fleet(config, device=device)
        self.engine = engine if engine is not None \
            else build_engine(config, device=device)
        self.agent = build_agent(config, self.engine)
        self.scaler = self._build_scaler()
        self.server = WebSocketLLMServer(config, self.engine, self.agent)
        self.watchdog_interval_s = watchdog_interval_s
        self._stop = asyncio.Event()
        self.restart_budget = RestartBudget(
            max_restarts=config.supervisor_max_restarts,
            window_s=config.supervisor_window_s,
            backoff_s=config.supervisor_backoff_s)
        self._events = get_events()
        self._m_restarts = get_metrics().counter(
            "engine_restarts_total",
            "supervised engine restarts after a crash")
        # The bound (host, port) of each app once ``run`` serves (an
        # ephemeral port 0 resolves here).
        self.addresses: dict[str, Any] = {}

    def _build_scaler(self):
        """The elastic scaler over a FleetRouter when ``FLEET_SCALE_MAX`` >
        0 (Config requires ``ROUTER_ENABLED`` for it), else None. A new
        replica is a ``build_engine`` on the launcher's device; a prefill
        one gets the deepened queue ``build_fleet`` gives the base tier."""
        cfg = self.config
        if cfg.fleet_scale_max <= 0 \
                or not hasattr(self.engine, "add_replica"):
            return None
        from dataclasses import replace as dc_replace

        from fasttalk_tpu_torch.observability.slo import get_slo
        from fasttalk_tpu_torch.router.elastic import ElasticScaler
        from fasttalk_tpu_torch.router.replica import ReplicaHandle

        def build_replica(replica_id: str,
                          role: str = "mixed") -> ReplicaHandle:
            ecfg = cfg
            if role == "prefill":
                ecfg = dc_replace(cfg, sched_queue_bound=4
                                  * cfg.sched_queue_bound)
            return ReplicaHandle(replica_id,
                                 build_engine(ecfg, device=self.device),
                                 role=role,
                                 dead_probes=cfg.router_dead_probes)

        return ElasticScaler(
            self.engine, build_replica,
            min_replicas=cfg.fleet_scale_min,
            max_replicas=cfg.fleet_scale_max,
            up_queue_depth=cfg.fleet_scale_up_queue,
            down_idle_s=cfg.fleet_scale_down_idle_s,
            check_interval_s=cfg.fleet_scale_check_s,
            slo_alerts=lambda: get_slo().alert_summary())

    def supervisor_info(self) -> dict:
        """Supervisor state for the monitoring port's ``/health``: while
        "exhausted", the health surface reports dead."""
        return self.restart_budget.state()

    def _ready(self) -> bool:
        """``/health/ready``: the engine is up and the supervisor has not
        given up on it."""
        return (not self.restart_budget.exhausted
                and self.engine.check_connection())

    async def _watchdog(self, interval: float = 5.0) -> None:
        """Supervised in-process recovery: a dead engine thread is restarted
        (its in-flight requests already got their terminal events from the
        crash; requests submitted since are served after the restart).
        Attempts are metered by ``restart_budget``: backoff after every
        attempt, successful or not (a poisoned device state restarts and
        dies on the next call), and no attempt once it is exhausted."""
        while not self._stop.is_set():
            await asyncio.sleep(interval)
            if self._stop.is_set():
                return
            if self._spmd_sink is not None \
                    and self._spmd_sink.dead_reason is not None:
                # A dead follower killed the cluster (spmd_serving
                # ``_fatal``): even with the engine thread idling, the
                # gateway comes down for a cluster restart.
                log.critical("SPMD cluster dead "
                             f"({self._spmd_sink.dead_reason}); "
                             "shutting the gateway down")
                self._stop.set()
                return
            if self.engine.check_connection():
                continue
            if self._spmd_sink is not None:
                # An in-place restart is this rank's state surgery and is
                # not replicated: an SPMD engine death ends the process so
                # the cluster restarts.
                log.critical("engine thread died in multi-host SPMD "
                             "serving; shutting the gateway down for a "
                             "cluster restart")
                self._stop.set()
                return
            restart = getattr(self.engine, "restart", None)
            if restart is None or not self.config.engine_auto_restart:
                continue
            if not self.restart_budget.allow():
                if self.restart_budget.exhausted:
                    self._note_exhausted()
                continue
            backoff = self.restart_budget.note_attempt()
            log.error("engine thread is down; attempting restart "
                      f"(next attempt no sooner than {backoff:.1f}s)")
            try:
                ok = await asyncio.get_running_loop().run_in_executor(
                    None, restart)
            except Exception as e:
                log.error(f"engine restart raised: {e}", exc_info=True)
                ok = False
            if ok:
                self._m_restarts.inc()
            (log.info if ok else log.error)(
                f"engine restart {'succeeded' if ok else 'failed'}")
            await asyncio.sleep(backoff)

    _exhausted_logged = False

    def _note_exhausted(self) -> None:
        if self._exhausted_logged:
            return
        self._exhausted_logged = True
        st = self.restart_budget.state()
        log.critical(
            f"supervisor restart budget exhausted "
            f"({st['max_restarts']} restarts in {st['window_s']:.0f}s); "
            "the engine stays down and /health reports dead — "
            "restart the process to recover")
        self._events.emit("supervisor_exhausted", severity="critical",
                          **st)

    def verify_backend(self) -> None:
        """Pre-flight: warm up, start, and refuse to serve an engine that
        is not running."""
        self.engine.warmup(self.config.warmup)
        self.engine.start()
        if not self.engine.check_connection():
            raise LLMServiceError("Engine failed pre-flight check")
        log.info("engine pre-flight check passed",
                 model=self.engine.get_model_info().get("model"))

    async def run(self) -> None:
        self.verify_backend()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, self._stop.set)
            except (NotImplementedError, RuntimeError):
                pass  # not the main thread, or not unix
        main_runner = web.AppRunner(self.server.app)
        mon_runner = web.AppRunner(build_monitoring_app(
            ready_check=self._ready,
            sched_info=getattr(self.engine, "scheduler_debug", None),
            supervisor_info=self.supervisor_info,
            fault_http=self.config.fault_http_enabled,
            # Router-fronted: a request ran on a replica, so the monitoring
            # port's /traces/{rid} falls back to the stitched fleet trace.
            trace_lookup=getattr(self.engine, "stitched_trace", None)))
        watchdog = None
        try:
            await main_runner.setup()
            await web.TCPSite(main_runner, self.config.host,
                              self.config.port).start()
            self.addresses["serving"] = main_runner.addresses[0]
            log.info(f"WebSocket server on ws://{self.config.host}:"
                     f"{self.addresses['serving'][1]}/ws/llm")
            await mon_runner.setup()
            await web.TCPSite(mon_runner, self.config.monitoring_host,
                              self.config.monitoring_port).start()
            self.addresses["monitoring"] = mon_runner.addresses[0]
            log.info(f"Monitoring on http://{self.config.monitoring_host}:"
                     f"{self.addresses['monitoring'][1]}/health")
            watchdog = asyncio.create_task(
                self._watchdog(self.watchdog_interval_s))
            if self.scaler is not None:
                self.scaler.start()
                log.info("elastic scaler on: fleet "
                         f"[{self.config.fleet_scale_min}, "
                         f"{self.config.fleet_scale_max}] replicas")
            await self._stop.wait()
        finally:
            log.info("shutting down: draining")
            if self.scaler is not None:
                self.scaler.stop()
            if watchdog is not None:
                watchdog.cancel()
                await asyncio.gather(watchdog, return_exceptions=True)
            await self.server.drain()
            await main_runner.cleanup()
            await mon_runner.cleanup()
            if self.agent is not None:
                # The search backend's HTTP session.
                await self.agent.aclose()
            self.engine.shutdown()
            if self._spmd_sink is not None:
                # After the engine stopped publishing: the stop frame is
                # the stream's clean tail.
                self._spmd_sink.close()

    def start(self) -> None:
        """Blocking entry point (signal-driven shutdown)."""
        asyncio.run(self.run())

    def stop(self) -> None:
        self._stop.set()
