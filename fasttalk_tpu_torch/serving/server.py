"""WebSocket + HTTP serving on aiohttp: the reference JSON protocol.

Counterpart of ``fasttalk_tpu/serving/server.py`` (:66-1056) without the
router and KV-migration surfaces, the same wire protocol on ``/ws/llm``:

  client -> server: start_session, update_config, user_message, cancel,
                    end_session
  server -> client: session_started, session_configured, config_updated,
                    token, tool_call, response_complete, cancelled,
                    session_ended, error

plus HTTP GET ``/`` (service banner), ``/health`` (degraded for a dead
engine, an overload state of the scheduler, a stalled engine or request,
or a page-level SLO burn), ``/stats`` (connections, conversations, the
error history, the engine's stats and process-lifetime totals),
``/metrics`` (Prometheus text of ``utils/metrics.py``), ``/slo`` (the SLO
report), ``/traces/{request_id}`` (this process's trace fragments of a
request) and ``/models``, and the OpenAI-compatible routes ``/v1/models``,
``/v1/chat/completions`` and ``/v1/completions`` (serving/openai_api.py).
``serve`` also runs the monitoring app (monitoring/monitor.py) on
``LLM_MONITORING_HOST:LLM_MONITORING_PORT``.

An optional ``agent`` (agents/voice_agent.py ``VoiceAgent``, built only by
serving/launcher.py ``build_agent``, as in the JAX package) is the
generation backend when given: it takes the WebSocket and ``/v1``
generations, ``cancel``, ``release_session`` and ``update_config``, and
``/``, ``/health`` and ``session_started`` report ``agent_enabled``.
Frames name the provider ``torch`` for the in-tree engine and the
configured ``LLM_PROVIDER`` for any other backend. ``serving.ws.send`` is
the failpoint seam of every frame sent (resilience/failpoints.py).

Connections go through ``ConnectionManager`` (serving/connection.py): a
refusal at ``LLM_MAX_CONNECTIONS`` carries its ``retry_after_hint``, and
a housekeeping task (every ``housekeeping_s``) drops conversations idle
past ``SESSION_TIMEOUT`` and closes the idle connections. The stall
watchdog (observability/watchdog.py) runs as a task beside it; a request
it terminates ends with a ``stalled`` error frame. The host profiler
starts with the server (unless ``PROF_ENABLED=false``) and stops at its
cleanup; the flight recorder subscribes to the event log.

Token frames carry the delta in ``data``; with the session key
``tts_chunking`` they carry speakable chunks instead (``"speakable":
true``). The session keys ``priority`` and ``deadline_s`` reach the
engine's ``GenerationParams`` (admission class and queue deadline),
``structured`` its constrained decoding spec, and ``journey`` the
per-token stamps: frames then carry the server's wall clock (``st``) and
``response_complete`` a ``journey`` waterfall. A shed at admission and
an engine terminal error whose code is a shed reach the client as a
``rate_limit_error`` frame with ``retry_after`` and do not count against
the circuit breaker. A generation runs as an asyncio task, so ``cancel``
is received mid-stream. On shutdown (``serve``) the server drains: new
submissions shed, and running generations get ``SCHED_DRAIN_TIMEOUT_S``
to finish.
"""

from __future__ import annotations

import asyncio
import json
import time
import uuid
from typing import Any

from aiohttp import WSCloseCode, WSMsgType, web

from fasttalk_tpu_torch import __version__
from fasttalk_tpu_torch.engine.engine import (EngineBase, GenerationParams,
                                              TorchEngine)
from fasttalk_tpu_torch.observability.flight import get_flight
from fasttalk_tpu_torch.observability.journey import JourneyRecorder
from fasttalk_tpu_torch.observability.perf import get_perf
from fasttalk_tpu_torch.observability.profiler import get_profiler
from fasttalk_tpu_torch.observability.slo import get_slo
from fasttalk_tpu_torch.observability.stitch import collect_fragments, stitch
from fasttalk_tpu_torch.observability.trace import (bind_request,
                                                    current_trace_id,
                                                    get_tracer,
                                                    mint_trace_id)
from fasttalk_tpu_torch.observability.watchdog import get_watchdog
from fasttalk_tpu_torch.resilience import failpoints as _fp
from fasttalk_tpu_torch.serving.connection import (ConnectionManager,
                                                   ConnectionState)
from fasttalk_tpu_torch.serving.conversation import ConversationManager
from fasttalk_tpu_torch.serving.openai_api import register_openai_routes
from fasttalk_tpu_torch.serving.text_processor import extract_speakable_chunk
from fasttalk_tpu_torch.utils.config import Config
from fasttalk_tpu_torch.utils.errors import (ENGINE_SHED_CODES,
                                             AdmissionRejected,
                                             CircuitBreaker,
                                             CircuitBreakerOpen,
                                             ErrorCategory, ErrorHandler,
                                             LLMServiceError)
from fasttalk_tpu_torch.utils.logger import get_logger
from fasttalk_tpu_torch.utils.metrics import get_metrics

log = get_logger("serving.server")

PROVIDER = "torch"


class WebSocketLLMServer:
    # Generation-config keys a client may set per session.
    _GEN_KEYS = ("temperature", "top_p", "top_k", "max_tokens", "stop",
                 "tts_chunking", "repeat_penalty", "presence_penalty",
                 "frequency_penalty", "ignore_eos", "priority", "deadline_s",
                 "structured", "journey")

    def __init__(self, config: Config, engine: EngineBase,
                 agent: Any | None = None, housekeeping_s: float = 60.0):
        self.config = config
        self.engine = engine
        self.agent = agent  # optional VoiceAgent (the tool-calling path)
        self.provider = (PROVIDER if isinstance(engine, TorchEngine)
                         else config.llm_provider)
        self.housekeeping_s = housekeeping_s
        self.connections = ConnectionManager(
            max_connections=config.max_connections,
            idle_timeout=config.session_timeout)
        tokenizer = getattr(engine, "tokenizer", None)
        count = (lambda s: len(tokenizer.encode(s))) if tokenizer else None  # noqa: E731
        self.conversations = ConversationManager(
            count_tokens=count,
            max_history_tokens=max(256, config.default_context_window
                                   - config.default_max_tokens),
            session_timeout=config.session_timeout,
            default_system_prompt=config.system_prompt or None)
        self.error_handler = ErrorHandler()
        self.breaker = CircuitBreaker()
        self._gen_tasks: dict[str, asyncio.Task] = {}
        self._cur_request: dict[str, str] = {}
        self._tasks: list[asyncio.Task] = []
        # Stall watchdog: heartbeats the engine loop, flags token-stalled
        # requests and ends the hopeless ones with a terminal error.
        self.watchdog = get_watchdog()
        self.watchdog.bind_engine(engine)
        # Flight recorder: SLO pages and stalls snapshot their evidence.
        get_flight().install()
        # Host stack sampler (a no-op with PROF_ENABLED=false); stopped
        # at cleanup, so no sampler outlives the server.
        self.profiler = get_profiler()
        self.profiler.start()
        m = get_metrics()
        self._m_ws_tokens = m.counter("ws_tokens_streamed_total",
                                      "token frames streamed to clients")
        self._m_ws_send = m.histogram(
            "ws_send_ms", "WebSocket frame send wall time (request-"
            "correlated frames only)",
            buckets=(0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250,
                     1000))
        self._tracer = get_tracer().scoped("serving")
        self.app = web.Application()
        self.app.router.add_get("/", self._http_root)
        self.app.router.add_get("/health", self._http_health)
        self.app.router.add_get("/stats", self._http_stats)
        self.app.router.add_get("/metrics", self._http_metrics)
        self.app.router.add_get("/slo", self._http_slo)
        self.app.router.add_get("/traces/{request_id}", self._http_trace)
        self.app.router.add_get("/models", self._http_models)
        self.app.router.add_get("/ws/llm", self.handle_websocket)
        register_openai_routes(
            self.app, backend=self._backend,
            model_name=self._model_name,
            defaults={"temperature": config.default_temperature,
                      "top_p": config.default_top_p,
                      "top_k": config.default_top_k,
                      "max_tokens": config.default_max_tokens,
                      "repeat_penalty": config.default_repeat_penalty,
                      "presence_penalty": config.default_presence_penalty,
                      "frequency_penalty": config.default_frequency_penalty,
                      "priority": config.sched_default_priority},
            breaker=self.breaker)
        self.app.on_startup.append(self._on_startup)
        self.app.on_cleanup.append(self._on_cleanup)

    # ---------------- lifecycle ----------------

    async def _on_startup(self, app: web.Application) -> None:
        self._tasks = [asyncio.create_task(self._housekeep()),
                       asyncio.create_task(self.watchdog.run())]

    async def drain(self) -> None:
        """Graceful drain (the JAX server's shutdown, :229-238): new
        submissions shed with retry_after from here on, while generations
        already streaming (or queued) get up to SCHED_DRAIN_TIMEOUT_S to
        finish. ``serve`` runs it before the app shuts down; the drain is
        the engine's for good, so an app that shares its engine with others
        (tests) is cleaned up without it."""
        self.engine.begin_drain()
        pending = [t for t in self._gen_tasks.values() if not t.done()]
        if pending and self.config.sched_drain_timeout_s > 0:
            await asyncio.wait(pending,
                               timeout=self.config.sched_drain_timeout_s)

    async def _on_cleanup(self, app: web.Application) -> None:
        tasks = self._tasks + list(self._gen_tasks.values())
        for task in tasks:
            task.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        self._tasks = []
        get_flight().uninstall()
        # The sampler exits within one period (about 15 ms) of the stop.
        self.profiler.stop()

    async def _housekeep(self) -> None:
        """Every ``housekeeping_s``: one ``housekeep_once`` pass."""
        while True:
            await asyncio.sleep(self.housekeeping_s)
            await self.housekeep_once()

    async def housekeep_once(self) -> None:
        """Drop conversations idle past SESSION_TIMEOUT and close the
        connections idle past it (JAX :241-256)."""
        try:
            self.conversations.cleanup_idle_sessions()
            for sid in self.connections.idle_sessions():
                info = self.connections.get_connection(sid)
                if info is not None:
                    log.info(f"[{sid}] closing idle connection")
                    await info.websocket.close()
        except asyncio.CancelledError:
            raise
        except Exception as e:
            log.error(f"housekeeping error: {e}", exc_info=True)

    def _backend(self) -> Any:
        """The generation backend: the agent when there is one (the same
        seam), else the engine."""
        return self.agent if self.agent is not None else self.engine

    def _model_name(self) -> str:
        return self.engine.get_model_info().get("model",
                                                self.config.model_name)

    # ---------------- HTTP ----------------

    async def _http_root(self, request: web.Request) -> web.Response:
        return web.json_response({
            "service": "FastTalk-TPU LLM Service",
            "status": "ready",
            "version": __version__,
            "provider": self.provider,
            "model": self._model_name(),
            "agent_enabled": self.agent is not None,
            "web_search_enabled": self.config.enable_web_search,
            "tools_enabled": self.config.enable_tools,
        })

    async def _http_health(self, request: web.Request) -> web.Response:
        try:
            ok = await asyncio.to_thread(self.engine.check_connection)
            body: dict[str, Any] = {
                "status": "healthy" if ok else "degraded",
                "provider": self.provider,
                "model": self._model_name(),
                "backend_connection": ok,
                "agent_enabled": self.agent is not None,
                "active_connections": self.connections.get_active_count(),
                "active_sessions": self.conversations.get_session_count(),
                "circuit_breaker": self.breaker.to_dict(),
            }
            # The overload state (pressured, shedding, draining) shows
            # before the cliff; it does not change the status code.
            sched = self.engine.get_stats().get("scheduler")
            if sched is not None:
                body["scheduler"] = sched
                if sched.get("state") != "healthy":
                    body["status"] = sched["state"]
            # A hung engine step, token-stalled requests or a page-level
            # SLO burn degrade the serving-port health too (still 200).
            wd = self.watchdog.status()
            if not wd["ok"]:
                body["status"] = "degraded"
                body["watchdog"] = wd
            slo = get_slo().alert_summary()
            if slo:
                body["slo"] = slo
                if any(state == "page" for state in slo.values()):
                    body["status"] = "degraded"
            return web.json_response(body, status=200 if ok else 503)
        except Exception as e:
            return web.json_response({"status": "unhealthy",
                                      "error": str(e)}, status=503)

    async def _http_stats(self, request: web.Request) -> web.Response:
        m = get_metrics()
        return web.json_response({
            "connections": self.connections.get_statistics(),
            "conversations": self.conversations.get_statistics(),
            "errors": self.error_handler.get_error_stats(),
            "engine": self.engine.get_stats(),
            "lifetime": {  # process-lifetime totals
                "tokens_generated":
                    m.counter("engine_tokens_generated_total").value,
                "requests": m.counter("engine_requests_total").value,
                "ttft_ms": m.histogram("engine_ttft_ms").summary(),
                "uptime_seconds": m.uptime(),
            },
            "provider": self.provider,
        })

    async def _http_metrics(self, request: web.Request) -> web.Response:
        text = await asyncio.to_thread(get_metrics().prometheus)
        return web.Response(text=text,
                            content_type="text/plain; version=0.0.4",
                            charset="utf-8")

    async def _http_slo(self, request: web.Request) -> web.Response:
        return web.json_response(await asyncio.to_thread(get_slo().snapshot))

    async def _http_trace(self, request: web.Request) -> web.Response:
        """This process's trace fragments of a request, stitched into one
        timeline (JAX :395-425; the port has no fleet router)."""
        request_id = request.match_info["request_id"]
        trace_id = request.query.get("trace_id", "")

        def build() -> dict[str, Any]:
            frags = collect_fragments(get_tracer(), request_id, trace_id)
            body: dict[str, Any] = {"request_id": request_id,
                                    "fragments": frags}
            if frags:
                body["stitched"] = stitch(frags)
            return body

        body = await asyncio.to_thread(build)
        if not body["fragments"]:
            return web.json_response(
                {"error": f"no trace for {request_id}"}, status=404)
        return web.json_response(
            body, dumps=lambda o: json.dumps(o, default=str))

    async def _http_models(self, request: web.Request) -> web.Response:
        return web.json_response(self._backend().get_model_info())

    # ---------------- WebSocket ----------------

    async def handle_websocket(self, request: web.Request,
                               ) -> web.WebSocketResponse:
        ws = web.WebSocketResponse(heartbeat=30)
        await ws.prepare(request)
        session_id = str(uuid.uuid4())
        if self.connections.add_connection(session_id, ws) is None:
            # Counted in ws_connections_rejected_total; the back-off hint
            # grows with the share of connections mid-generation.
            await ws.send_json({"type": "error", "error": {
                "code": "max_connections",
                "message": "Maximum connections reached",
                "severity": "high",
                "retry_after": self.connections.retry_after_hint()}})
            await ws.close(code=WSCloseCode.TRY_AGAIN_LATER,
                           message=b"max connections; retry later")
            return ws
        try:
            await self._send(session_id, ws, {
                "type": "session_started", "session_id": session_id,
                "provider": self.provider, "model": self._model_name(),
                "agent_enabled": self.agent is not None})
            async for msg in ws:
                if msg.type == WSMsgType.TEXT:
                    self.connections.record_message_received(session_id)
                    await self._dispatch(session_id, msg.data, ws)
                elif msg.type in (WSMsgType.ERROR, WSMsgType.CLOSE):
                    break
        finally:
            task = self._gen_tasks.pop(session_id, None)
            if task is not None:
                task.cancel()
            rid = self._cur_request.pop(session_id, None)
            if rid is not None:
                self._backend().cancel(rid)
            self._backend().release_session(session_id)
            self.connections.remove_connection(session_id)
            self.conversations.end_session(session_id)
        return ws

    async def _send(self, session_id: str, ws: web.WebSocketResponse,
                    payload: dict, request_id: str | None = None) -> None:
        """Send one frame; a request-correlated one is timed into
        ``ws_send_ms`` and the request's trace (a slow client's
        backpressure shows here)."""
        if ws.closed:
            return
        if _fp.enabled:
            # Chaos seam: `error` is a peer reset mid-send (the stream's
            # teardown must cancel the generation and free the slot);
            # `corrupt` delivers a non-JSON text frame. fire_async: a delay
            # or hang stalls this stream, not the event loop.
            if await _fp.fire_async(
                    "serving.ws.send", exc=ConnectionResetError,
                    session_id=session_id,
                    request_id=request_id or "") == "corrupt":
                await ws.send_str("\x00corrupt-frame\x00")
                return
        if request_id is not None:
            t0 = time.monotonic()
            await ws.send_json(payload)
            t1 = time.monotonic()
            self._m_ws_send.observe((t1 - t0) * 1000)
            self._tracer.add_span(request_id, "ws_send", t0, t1,
                                  frame=payload.get("type"))
        else:
            await ws.send_json(payload)
        self.connections.record_message_sent(session_id)

    async def _send_error(self, session_id: str, ws: web.WebSocketResponse,
                          code: str, message: str) -> None:
        await self._send(session_id, ws, {
            "type": "error", "error": {"code": code, "message": message}})

    async def _dispatch(self, session_id: str, raw: str,
                        ws: web.WebSocketResponse) -> None:
        try:
            message = json.loads(raw)
        except json.JSONDecodeError:
            await self._send_error(session_id, ws, "invalid_json",
                                   "Invalid JSON format")
            return
        msg_type = message.get("type")
        try:
            await self._handle(session_id, msg_type, message, ws)
        except Exception as e:
            log.error(f"[{session_id}] error handling {msg_type}: {e}",
                      exc_info=True)
            self.connections.record_error(session_id)
            err = self.error_handler.handle_error(e,
                                                  {"session_id": session_id})
            await self._send(session_id, ws, {"type": "error",
                                              "error": err.to_dict()})

    async def _handle(self, session_id: str, msg_type: Any, message: dict,
                      ws: web.WebSocketResponse) -> None:
        if msg_type in ("start_session", "update_config"):
            cfg = message.get("config", {}) or {}
            gen = {k: cfg[k] for k in self._GEN_KEYS if k in cfg}
            if isinstance(gen.get("stop"), str):
                gen["stop"] = [gen["stop"]]
            info = self.connections.get_connection(session_id)
            if msg_type == "start_session":
                self.conversations.create_session(
                    session_id,
                    system_prompt=cfg.get("system_prompt",
                                          self.config.system_prompt),
                    gen_config=gen)
                if info is not None:
                    info.config = dict(cfg)
                await self._send(session_id, ws, {
                    "type": "session_configured", "config": cfg,
                    "provider": self.provider})
            else:
                if "system_prompt" in cfg:
                    gen["system_prompt"] = cfg["system_prompt"]
                self.conversations.update_config(session_id, gen)
                if info is not None:
                    info.config.update(cfg)
                if self.agent is not None \
                        and hasattr(self.agent, "update_config"):
                    self.agent.update_config(**gen)
                await self._send(session_id, ws, {
                    "type": "config_updated", "success": True,
                    "config": cfg})
        elif msg_type == "user_message":
            text = message.get("text", "")
            if not text:
                await self._send_error(session_id, ws, "empty_message",
                                       "Empty user message")
                return
            task = self._gen_tasks.get(session_id)
            if task is not None and not task.done():
                await self._send_error(
                    session_id, ws, "generation_in_progress",
                    "A generation is already running for this session; "
                    "cancel it first")
                return
            self.conversations.add_user_message(session_id, text)
            self.connections.update_connection_state(
                session_id, ConnectionState.PROCESSING)
            self._gen_tasks[session_id] = asyncio.create_task(
                self._generate(session_id, ws))
        elif msg_type == "cancel":
            rid = self._cur_request.get(session_id)
            ok = self._backend().cancel(rid) if rid else False
            await self._send(session_id, ws, {"type": "cancelled",
                                              "success": ok})
        elif msg_type == "end_session":
            task = self._gen_tasks.pop(session_id, None)
            if task is not None and not task.done():
                rid = self._cur_request.get(session_id)
                if rid:
                    self._backend().cancel(rid)
                task.cancel()
                await asyncio.gather(task, return_exceptions=True)
            # Transition before the snapshot: the frame is the record of
            # the session's final state.
            self.connections.update_connection_state(
                session_id, ConnectionState.DISCONNECTING)
            info = self.connections.get_connection(session_id)
            self._backend().release_session(session_id)
            self.conversations.end_session(session_id)
            await self._send(session_id, ws, {
                "type": "session_ended",
                "stats": info.to_dict() if info else {}})
        else:
            await self._send_error(session_id, ws, "unknown_message_type",
                                   f"Unknown message type: {msg_type}")

    def _gen_params(self, session_id: str) -> GenerationParams:
        state = self.conversations.get(session_id)
        over = state.gen_config if state else {}
        stop = over.get("stop", [])
        ignore_eos = over.get("ignore_eos", False)
        if not isinstance(ignore_eos, bool):
            raise ValueError(f"ignore_eos must be a boolean, got {ignore_eos!r}")
        journey = over.get("journey", False)
        if not isinstance(journey, bool):
            raise ValueError(f"journey must be a boolean, got {journey!r}")
        c = self.config
        return GenerationParams(
            temperature=float(over.get("temperature", c.default_temperature)),
            top_k=int(over.get("top_k", c.default_top_k)),
            top_p=float(over.get("top_p", c.default_top_p)),
            max_tokens=int(over.get("max_tokens", c.default_max_tokens)),
            stop=[s for s in stop if isinstance(s, str) and s],
            repeat_penalty=float(over.get("repeat_penalty",
                                          c.default_repeat_penalty)),
            presence_penalty=float(over.get("presence_penalty",
                                            c.default_presence_penalty)),
            frequency_penalty=float(over.get("frequency_penalty",
                                             c.default_frequency_penalty)),
            ignore_eos=ignore_eos,
            # Admission class and queue deadline (GenerationParams checks
            # both; a bad value is an invalid_config frame).
            priority=str(over.get("priority", c.sched_default_priority)),
            deadline_s=(float(over["deadline_s"])
                        if over.get("deadline_s") is not None else None),
            # Constrained decoding; a bad spec shape is an invalid_config
            # frame through GenerationParams.
            structured=over.get("structured"),
            # Per-token journey stamps; JOURNEY_ENABLED=false ignores the
            # opt-in without erroring the client.
            journey=journey and c.journey_enabled)

    async def _generate(self, session_id: str,
                        ws: web.WebSocketResponse) -> None:
        request_id = f"{session_id}:{uuid.uuid4().hex[:8]}"
        self._cur_request[session_id] = request_id
        # The serving layer owns the request trace (the engine adds spans
        # to it) and binds the ids into the logging context.
        tid = current_trace_id() or mint_trace_id()
        self._tracer.start(request_id, session_id, trace_id=tid)
        with bind_request(request_id, trace_id=tid):
            try:
                await self._generate_traced(session_id, ws, request_id)
            finally:
                self._tracer.event(request_id, "request_complete")
                self._tracer.finish(request_id)

    async def _generate_traced(self, session_id: str,
                               ws: web.WebSocketResponse,
                               request_id: str) -> None:
        start = time.monotonic()
        full_text, stats, finish_reason = "", {}, "stop"
        state = self.conversations.get(session_id)
        tts = bool(state.gen_config.get("tts_chunking")) if state else False
        tts_buffer = ""
        jr: JourneyRecorder | None = None
        try:
            try:
                params = self._gen_params(session_id)
            except (TypeError, ValueError) as e:
                self.connections.record_error(session_id)
                await self._send_error(session_id, ws, "invalid_config",
                                       str(e))
                return
            if params.structured is not None:
                # An engine that cannot serve constraints is a config clash
                # for the client, not a backend failure: before the breaker.
                reason = getattr(self.engine, "structured_reason", None)
                if reason is not None:
                    self.connections.record_error(session_id)
                    await self._send_error(
                        session_id, ws, "invalid_config",
                        f"structured output unavailable: {reason}")
                    return
            self.breaker.check()
            if params.journey:
                # The engine stamps fetch/enqueue marks on each token
                # event; this loop adds the dequeue and the WS write.
                jr = JourneyRecorder(start)
            messages = self.conversations.get_messages_for_generation(
                session_id)
            async for event in self._backend().generate(
                    request_id, session_id, messages, params):
                etype = event["type"]
                if etype == "token":
                    t_dq = time.monotonic()  # event-loop dequeue mark
                    full_text += event["text"]
                    frame: dict[str, Any] | None
                    if tts:
                        tts_buffer += event["text"]
                        chunk, tts_buffer = extract_speakable_chunk(tts_buffer)
                        frame = ({"type": "token", "data": chunk,
                                  "speakable": True} if chunk else None)
                    else:
                        frame = {"type": "token", "data": event["text"]}
                    if frame is not None:
                        if jr is not None:
                            # The server's wall clock lets a client
                            # estimate RTT and clock offset.
                            frame["st"] = time.time()
                        await self._send(session_id, ws, frame,
                                         request_id=request_id)
                        self._m_ws_tokens.inc()
                        if jr is not None:
                            jr.frame(event.get("j"), t_dq, time.monotonic())
                elif etype in ("done", "cancelled"):
                    stats = event.get("stats", {})
                    finish_reason = ("cancelled" if etype == "cancelled"
                                     else event.get("finish_reason", "stop"))
                elif etype == "tool_call":
                    # The agent ran a tool: clients render the activity.
                    await self._send(session_id, ws, {
                        "type": "tool_call", "tool": event.get("tool"),
                        "arguments": event.get("arguments")},
                        request_id=request_id)
                elif etype == "error":
                    if event.get("code") in ENGINE_SHED_CODES:
                        # Load shedding (deadline, KV block pool): a
                        # rate-limit frame with retry_after, not a fault.
                        raise AdmissionRejected.from_shed_event(event)
                    if event.get("code") == "stalled":
                        # Ended by the stall watchdog: a backend fault the
                        # breaker counts, with the engine's code kept so a
                        # client tells a hung backend from a model error.
                        self.breaker.record_failure()
                        self.connections.record_error(session_id)
                        await self._send(session_id, ws, {
                            "type": "error",
                            "error": {"code": "stalled",
                                      "message": event.get("error", ""),
                                      "severity": "high",
                                      "recoverable": True}},
                            request_id=request_id)
                        return
                    raise LLMServiceError(event.get("error", "engine error"))
            if tts and tts_buffer:
                await self._send(session_id, ws, {
                    "type": "token", "data": tts_buffer, "speakable": True},
                    request_id=request_id)
            self.breaker.record_success()
            tokens = int(stats.get("tokens_generated") or 0)
            self.conversations.add_assistant_message(
                session_id, full_text, tokens_generated=tokens)
            self.connections.record_tokens_generated(session_id, tokens)
            self.connections.record_generation_complete(session_id)
            journey_summary = None
            if jr is not None and jr.frames:
                journey_summary = jr.summary()
                self._tracer.add_span(request_id, "token_journey", start,
                                      time.monotonic(), **jr.span_attrs())
                get_perf().note_journey(journey_summary["hops_ms"],
                                        jr.frames)
            await self._send(session_id, ws, {
                "type": "response_complete", "stats": {
                    "tokens_generated": tokens,
                    "processing_time_ms": stats.get(
                        "processing_time_ms",
                        (time.monotonic() - start) * 1000),
                    "tokens_per_second":
                        stats.get("tokens_per_second") or 0.0,
                    "ttft_ms": stats.get("ttft_ms"),
                    "prompt_tokens": stats.get("prompt_tokens"),
                    "prefill_tokens": stats.get("prefill_tokens"),
                    "finish_reason": finish_reason,
                    "provider": self.provider,
                    **({"journey": journey_summary}
                       if journey_summary is not None else {}),
                }}, request_id=request_id)
        except asyncio.CancelledError:
            self._backend().cancel(request_id)
            raise
        except CircuitBreakerOpen as e:
            self.connections.record_error(session_id)
            await self._send(session_id, ws,
                             {"type": "error", "error": e.to_dict()})
        except AdmissionRejected as e:
            # Load shed (queue bound, deadline, drain, blocks): the client
            # backs off by retry_after; shedding is not a backend fault,
            # so the breaker is untouched.
            self.connections.record_error(session_id)
            await self._send(session_id, ws,
                             {"type": "error", "error": e.to_dict()})
        except LLMServiceError as e:
            if e.category not in (ErrorCategory.VALIDATION,
                                  ErrorCategory.RATE_LIMIT):
                self.breaker.record_failure()
            self.error_handler.handle_error(e, {"session_id": session_id})
            self.connections.record_error(session_id)
            await self._send(session_id, ws,
                             {"type": "error", "error": e.to_dict()})
        except Exception as e:  # the stream must end with a frame
            self.breaker.record_failure()
            log.error(f"[{session_id}] generation error: {e}", exc_info=True)
            self.connections.record_error(session_id)
            err = self.error_handler.handle_error(e,
                                                  {"session_id": session_id})
            await self._send(session_id, ws,
                             {"type": "error", "error": err.to_dict()})
        finally:
            self._cur_request.pop(session_id, None)
            self.connections.update_connection_state(
                session_id, ConnectionState.ACTIVE)


async def serve(config: Config, engine: EngineBase,
                stop: asyncio.Event) -> None:
    """Run the server on config.host:config.port, and the monitoring app
    on config.monitoring_host:config.monitoring_port (JAX
    ``serving/launcher.py`` :320-334), until ``stop`` is set."""
    from fasttalk_tpu_torch.monitoring.monitor import build_monitoring_app

    server = WebSocketLLMServer(config, engine)
    runner = web.AppRunner(server.app)
    monitor = web.AppRunner(build_monitoring_app(
        ready_check=engine.check_connection,
        sched_info=getattr(engine, "scheduler_debug", None)))
    await runner.setup()
    await monitor.setup()
    try:
        await web.TCPSite(runner, config.host, config.port).start()
        await web.TCPSite(monitor, config.monitoring_host,
                          config.monitoring_port).start()
        log.info(f"serving /ws/llm on {config.host}:{config.port}, "
                 f"monitoring on {config.monitoring_host}:"
                 f"{config.monitoring_port}")
        await stop.wait()
        log.info("shutting down: draining")
        await server.drain()
    finally:
        await monitor.cleanup()
        await runner.cleanup()
