"""WebSocket + HTTP serving on aiohttp: the reference JSON protocol.

Counterpart of the main path of ``fasttalk_tpu/serving/server.py``
(:522-1056), the same wire protocol on ``/ws/llm``:

  client -> server: start_session, user_message, cancel, end_session
  server -> client: session_started, session_configured, token,
                    response_complete, cancelled, session_ended, error

plus HTTP GET ``/health`` and ``/models``. Token frames carry the delta
in ``data``. A generation runs as an asyncio task, so ``cancel`` is
received mid-stream; per-session config from ``start_session`` applies
to every generation of the session.
"""

from __future__ import annotations

import asyncio
import json
import time
import uuid
from typing import Any

from aiohttp import WSCloseCode, WSMsgType, web

from fasttalk_tpu_torch import __version__
from fasttalk_tpu_torch.engine.engine import EngineBase, GenerationParams
from fasttalk_tpu_torch.serving.conversation import ConversationManager
from fasttalk_tpu_torch.utils.config import Config
from fasttalk_tpu_torch.utils.errors import (CircuitBreaker,
                                             CircuitBreakerOpen,
                                             ErrorCategory, LLMServiceError)
from fasttalk_tpu_torch.utils.logger import get_logger

log = get_logger("serving.server")

PROVIDER = "torch"


class WebSocketLLMServer:
    # Generation-config keys a client may set per session.
    _GEN_KEYS = ("temperature", "top_p", "top_k", "max_tokens", "stop",
                 "repeat_penalty", "presence_penalty", "frequency_penalty",
                 "ignore_eos")

    def __init__(self, config: Config, engine: EngineBase):
        self.config = config
        self.engine = engine
        tokenizer = getattr(engine, "tokenizer", None)
        count = (lambda s: len(tokenizer.encode(s))) if tokenizer else None  # noqa: E731
        self.conversations = ConversationManager(
            count_tokens=count,
            max_history_tokens=max(256, config.default_context_window
                                   - config.default_max_tokens),
            session_timeout=config.session_timeout,
            default_system_prompt=config.system_prompt or None)
        self.breaker = CircuitBreaker()
        self._connections: set[str] = set()
        self._gen_tasks: dict[str, asyncio.Task] = {}
        self._cur_request: dict[str, str] = {}
        self.app = web.Application()
        self.app.router.add_get("/health", self._http_health)
        self.app.router.add_get("/models", self._http_models)
        self.app.router.add_get("/ws/llm", self.handle_websocket)
        self.app.on_cleanup.append(self._on_cleanup)

    async def _on_cleanup(self, app: web.Application) -> None:
        tasks = list(self._gen_tasks.values())
        for task in tasks:
            task.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)

    def _model_name(self) -> str:
        return self.engine.get_model_info().get("model",
                                                self.config.model_name)

    # ---------------- HTTP ----------------

    async def _http_health(self, request: web.Request) -> web.Response:
        ok = self.engine.check_connection()
        return web.json_response({
            "status": "healthy" if ok else "unhealthy",
            "provider": PROVIDER,
            "version": __version__,
            "model": self._model_name(),
            "backend_connection": ok,
            "active_connections": len(self._connections),
            "active_sessions": self.conversations.get_session_count(),
            "circuit_breaker": self.breaker.to_dict(),
            "engine": self.engine.get_stats(),
        }, status=200 if ok else 503)

    async def _http_models(self, request: web.Request) -> web.Response:
        return web.json_response(self.engine.get_model_info())

    # ---------------- WebSocket ----------------

    async def handle_websocket(self, request: web.Request,
                               ) -> web.WebSocketResponse:
        ws = web.WebSocketResponse(heartbeat=30)
        await ws.prepare(request)
        session_id = str(uuid.uuid4())
        if len(self._connections) >= self.config.max_connections:
            await ws.send_json({"type": "error", "error": {
                "code": "max_connections",
                "message": "Maximum connections reached",
                "severity": "high", "retry_after": 1.0}})
            await ws.close(code=WSCloseCode.TRY_AGAIN_LATER)
            return ws
        self._connections.add(session_id)
        try:
            await ws.send_json({"type": "session_started",
                                "session_id": session_id,
                                "provider": PROVIDER,
                                "model": self._model_name()})
            async for msg in ws:
                if msg.type == WSMsgType.TEXT:
                    await self._dispatch(session_id, msg.data, ws)
                elif msg.type in (WSMsgType.ERROR, WSMsgType.CLOSE):
                    break
        finally:
            task = self._gen_tasks.pop(session_id, None)
            if task is not None:
                task.cancel()
            rid = self._cur_request.pop(session_id, None)
            if rid is not None:
                self.engine.cancel(rid)
            self.engine.release_session(session_id)
            self.conversations.end_session(session_id)
            self._connections.discard(session_id)
        return ws

    async def _send(self, ws: web.WebSocketResponse, payload: dict) -> None:
        if not ws.closed:
            await ws.send_json(payload)

    async def _send_error(self, ws: web.WebSocketResponse, code: str,
                          message: str) -> None:
        await self._send(ws, {"type": "error",
                              "error": {"code": code, "message": message}})

    async def _dispatch(self, session_id: str, raw: str,
                        ws: web.WebSocketResponse) -> None:
        try:
            message = json.loads(raw)
        except json.JSONDecodeError:
            await self._send_error(ws, "invalid_json", "Invalid JSON format")
            return
        msg_type = message.get("type")
        if msg_type == "start_session":
            cfg = message.get("config", {}) or {}
            gen = {k: cfg[k] for k in self._GEN_KEYS if k in cfg}
            if isinstance(gen.get("stop"), str):
                gen["stop"] = [gen["stop"]]
            self.conversations.create_session(
                session_id,
                system_prompt=cfg.get("system_prompt",
                                      self.config.system_prompt),
                gen_config=gen)
            await self._send(ws, {"type": "session_configured",
                                  "config": cfg, "provider": PROVIDER})
        elif msg_type == "user_message":
            text = message.get("text", "")
            if not text:
                await self._send_error(ws, "empty_message",
                                       "Empty user message")
                return
            task = self._gen_tasks.get(session_id)
            if task is not None and not task.done():
                await self._send_error(
                    ws, "generation_in_progress",
                    "A generation is already running for this session; "
                    "cancel it first")
                return
            self.conversations.add_user_message(session_id, text)
            self._gen_tasks[session_id] = asyncio.create_task(
                self._generate(session_id, ws))
        elif msg_type == "cancel":
            rid = self._cur_request.get(session_id)
            ok = self.engine.cancel(rid) if rid else False
            await self._send(ws, {"type": "cancelled", "success": ok})
        elif msg_type == "end_session":
            task = self._gen_tasks.pop(session_id, None)
            if task is not None and not task.done():
                rid = self._cur_request.get(session_id)
                if rid:
                    self.engine.cancel(rid)
                task.cancel()
                await asyncio.gather(task, return_exceptions=True)
            self.engine.release_session(session_id)
            state = self.conversations.get(session_id)
            self.conversations.end_session(session_id)
            await self._send(ws, {"type": "session_ended", "stats": {
                "turns": state.turns if state else 0,
                "tokens_generated":
                    state.total_tokens_generated if state else 0}})
        else:
            await self._send_error(ws, "unknown_message_type",
                                   f"Unknown message type: {msg_type}")

    def _gen_params(self, session_id: str) -> GenerationParams:
        state = self.conversations.get(session_id)
        over = state.gen_config if state else {}
        stop = over.get("stop", [])
        ignore_eos = over.get("ignore_eos", False)
        if not isinstance(ignore_eos, bool):
            raise ValueError(f"ignore_eos must be a boolean, got {ignore_eos!r}")
        c = self.config
        return GenerationParams(
            temperature=float(over.get("temperature", c.default_temperature)),
            top_k=int(over.get("top_k", c.default_top_k)),
            top_p=float(over.get("top_p", c.default_top_p)),
            max_tokens=int(over.get("max_tokens", c.default_max_tokens)),
            stop=[s for s in stop if isinstance(s, str) and s],
            repeat_penalty=float(over.get("repeat_penalty",
                                          c.default_repeat_penalty)),
            presence_penalty=float(over.get("presence_penalty", 0.0)),
            frequency_penalty=float(over.get("frequency_penalty", 0.0)),
            ignore_eos=ignore_eos)

    async def _generate(self, session_id: str,
                        ws: web.WebSocketResponse) -> None:
        request_id = f"{session_id}:{uuid.uuid4().hex[:8]}"
        self._cur_request[session_id] = request_id
        start = time.monotonic()
        full_text, stats, finish_reason = "", {}, "stop"
        try:
            try:
                params = self._gen_params(session_id)
            except (TypeError, ValueError) as e:
                await self._send_error(ws, "invalid_config", str(e))
                return
            self.breaker.check()
            messages = self.conversations.get_messages_for_generation(
                session_id)
            async for event in self.engine.generate(request_id, session_id,
                                                    messages, params):
                etype = event["type"]
                if etype == "token":
                    full_text += event["text"]
                    await self._send(ws, {"type": "token",
                                          "data": event["text"]})
                elif etype in ("done", "cancelled"):
                    stats = event.get("stats", {})
                    finish_reason = ("cancelled" if etype == "cancelled"
                                     else event.get("finish_reason", "stop"))
                elif etype == "error":
                    raise LLMServiceError(event.get("error", "engine error"))
            self.breaker.record_success()
            tokens = int(stats.get("tokens_generated") or 0)
            self.conversations.add_assistant_message(
                session_id, full_text, tokens_generated=tokens)
            await self._send(ws, {"type": "response_complete", "stats": {
                "tokens_generated": tokens,
                "processing_time_ms": stats.get(
                    "processing_time_ms", (time.monotonic() - start) * 1000),
                "tokens_per_second": stats.get("tokens_per_second") or 0.0,
                "ttft_ms": stats.get("ttft_ms"),
                "prompt_tokens": stats.get("prompt_tokens"),
                "prefill_tokens": stats.get("prefill_tokens"),
                "finish_reason": finish_reason,
                "provider": PROVIDER,
            }})
        except asyncio.CancelledError:
            self.engine.cancel(request_id)
            raise
        except CircuitBreakerOpen as e:
            await self._send(ws, {"type": "error", "error": e.to_dict()})
        except LLMServiceError as e:
            if e.category != ErrorCategory.VALIDATION:
                self.breaker.record_failure()
            await self._send(ws, {"type": "error", "error": e.to_dict()})
        except Exception as e:  # the stream must end with a frame
            self.breaker.record_failure()
            log.error(f"[{session_id}] generation error: {e}", exc_info=True)
            err: dict[str, Any] = {"code": "internal_error",
                                   "message": str(e) or type(e).__name__}
            await self._send(ws, {"type": "error", "error": err})
        finally:
            self._cur_request.pop(session_id, None)


async def serve(config: Config, engine: EngineBase,
                stop: asyncio.Event) -> None:
    """Run the server on config.host:config.port until ``stop`` is set."""
    server = WebSocketLLMServer(config, engine)
    runner = web.AppRunner(server.app)
    await runner.setup()
    try:
        await web.TCPSite(runner, config.host, config.port).start()
        log.info(f"serving /ws/llm on {config.host}:{config.port}")
        await stop.wait()
    finally:
        await runner.cleanup()
