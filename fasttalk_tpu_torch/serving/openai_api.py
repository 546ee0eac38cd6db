"""OpenAI-compatible HTTP API on the main serving port.

The reference reached its engine through this API from the client side
(vllm_handler.py:117-308 spoke /v1/chat/completions as a consumer);
serving it here means OpenAI-SDK clients, the reference's own vLLM
handler, and any PydanticAI-style framework can point at THIS engine —
the vLLM-parity surface of BASELINE config #3.

Implements: POST /v1/chat/completions (stream SSE + non-stream, with
OpenAI tools/tool_choice/tool_calls — the reference launched vLLM with
--enable-auto-tool-choice --tool-call-parser hermes,
docker-compose.vllm.yml:50-51, so PydanticAI could drive the tool loop;
here the hermes parsing is in-tree and the client drives the loop),
GET /v1/models. Authentication mirrors vLLM's "not needed but accepted".

The port's copy of ``fasttalk_tpu/serving/openai_api.py`` (imports only).
"""

from __future__ import annotations

import contextlib
import json
import time
import uuid
from typing import Any

from aiohttp import web

from typing import Callable

from fasttalk_tpu_torch.agents.hermes import (
    HermesStreamParser, format_tool_result, inject_tools_section,
    tools_system_prompt)
from fasttalk_tpu_torch.engine.engine import EngineBase, GenerationParams
from fasttalk_tpu_torch.engine.remote import _RemoteEngine
from fasttalk_tpu_torch.observability.trace import (
    bind_request, get_tracer, mint_trace_id, parse_traceparent,
    propagate_enabled)
from fasttalk_tpu_torch.structured.compiler import validate_structured_spec
from fasttalk_tpu_torch.utils.errors import (
    ENGINE_SHED_CODES, AdmissionRejected, CircuitBreaker, CircuitBreakerOpen,
    ErrorCategory, LLMServiceError)
from fasttalk_tpu_torch.utils.logger import get_logger

log = get_logger("serving.openai")


def _now() -> int:
    return int(time.time())


def _content_str(content: Any) -> str:
    """OpenAI message content may be a string or a list of typed parts."""
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        return "".join(p.get("text", "") for p in content
                       if isinstance(p, dict) and p.get("type") == "text")
    return "" if content is None else str(content)


class _BadRequest(ValueError):
    """Client-shape error: surfaces as a 400, never a 500/breaker hit."""


def _reject_429(e: AdmissionRejected) -> web.Response:
    """Load shed at admission → HTTP 429 with both the OpenAI-style
    error body and a standard Retry-After header (integer seconds,
    rounded up — a 0 would invite an immediate hot retry)."""
    import math as _math

    retry_s = max(1, int(_math.ceil(e.retry_after or 1.0)))
    return web.json_response(
        {"error": {"message": e.message, "type": "rate_limit_error",
                   "code": e.reason, "retry_after": e.retry_after}},
        status=429, headers={"Retry-After": str(retry_s)})


def _parse_tools(body: dict) -> tuple[list[dict], str | None]:
    """Extract hermes-format tool specs from an OpenAI `tools` array and
    resolve `tool_choice`. Returns (specs, forced_tool_name) — specs empty
    when tools are absent or tool_choice is "none"; forced_tool_name set
    for tool_choice "required" ("" = any tool) or a named function."""
    tools = body.get("tools")
    choice = body.get("tool_choice")
    if tools is not None and not isinstance(tools, list):
        raise _BadRequest("tools must be a list")
    if not tools:
        if choice == "required" or isinstance(choice, dict):
            raise _BadRequest("tool_choice requires a non-empty tools list")
        return [], None
    if choice == "none":
        return [], None
    specs = []
    for t in tools:
        fn = t.get("function", t) if isinstance(t, dict) else None
        if not isinstance(fn, dict) or not fn.get("name"):
            raise _BadRequest("each tool needs a function.name")
        specs.append({
            "name": fn["name"],
            "description": fn.get("description", ""),
            "parameters": fn.get("parameters",
                                 {"type": "object", "properties": {}}),
        })
    forced: str | None = None
    if choice == "required":
        forced = ""
    elif isinstance(choice, dict):
        fn = choice.get("function")
        if not isinstance(fn, dict) or not fn.get("name"):
            raise _BadRequest(
                "tool_choice object must be "
                '{"type": "function", "function": {"name": ...}}')
        forced = fn["name"]
        if forced not in {s["name"] for s in specs}:
            raise _BadRequest(
                f"tool_choice names unknown tool {forced!r}")
    elif choice not in (None, "auto"):
        raise _BadRequest(f"unsupported tool_choice {choice!r}")
    return specs, forced


def _parse_response_format(body: dict) -> dict | None:
    """OpenAI ``response_format`` → the engine's structured spec
    (docs/STRUCTURED.md). Returns None for absent/"text"."""
    rf = body.get("response_format")
    if rf is None:
        return None
    if not isinstance(rf, dict) or "type" not in rf:
        raise _BadRequest('response_format must be an object with a '
                          '"type"')
    t = rf["type"]
    if t == "text":
        return None
    if t == "json_object":
        return {"kind": "json_object"}
    if t == "json_schema":
        js = rf.get("json_schema")
        schema = js.get("schema") if isinstance(js, dict) else None
        if not isinstance(schema, dict):
            raise _BadRequest(
                "response_format.json_schema.schema must be a JSON "
                "Schema object")
        return {"kind": "json_schema", "schema": schema}
    raise _BadRequest(f"unsupported response_format type {t!r} "
                      "(supported: text, json_object, json_schema)")


def _check_structured_combos(body: dict, structured: dict | None,
                             specs: list[dict] | None = None) -> None:
    """Unsupported-combination guard: every rejection is a clean 400
    naming the clash, never a 500 from deep inside the engine."""
    if structured is None:
        return
    n = body.get("n", 1)
    if n not in (None, 1):
        raise _BadRequest(
            f"response_format with n={n!r} is not supported "
            "(constrained decoding serves one choice per request)")
    if specs:
        raise _BadRequest(
            "response_format cannot be combined with tools: the tool-"
            "call markup would violate the JSON contract (use "
            "tool_choice to force a schema-constrained tool call "
            "instead)")
    if body.get("ignore_eos"):
        raise _BadRequest(
            "response_format is incompatible with ignore_eos=true "
            "(the grammar decides where the document ends)")
    if body.get("stop"):
        raise _BadRequest(
            "response_format is incompatible with stop sequences: a "
            "stop string can truncate the document mid-grammar and "
            "break the validity guarantee (the grammar decides where "
            "the document ends)")


def _structured_denied(engine) -> str | None:
    """The engine's structured-availability reason (None = available).
    Duck-typed: remote/fake engines without the attribute pass the
    spec through and decide upstream."""
    return getattr(_unwrap_agent(engine), "structured_reason", None)


def _hermes_messages(messages: list[dict]) -> list[dict]:
    """Rewrite OpenAI tool-protocol messages (assistant `tool_calls`,
    role "tool" results keyed by tool_call_id) into the hermes markup the
    engine's chat templates render natively."""
    id_to_name: dict[str, str] = {}
    out: list[dict] = []
    for m in messages:
        role = m.get("role", "user")
        content = _content_str(m.get("content"))
        if role == "assistant" and m.get("tool_calls"):
            if not isinstance(m["tool_calls"], list):
                raise _BadRequest("tool_calls must be a list")
            parts = [content] if content else []
            for tc in m["tool_calls"]:
                if not isinstance(tc, dict):
                    raise _BadRequest("tool_calls entries must be objects")
                fn = tc.get("function", {})
                if not isinstance(fn, dict):
                    raise _BadRequest("tool_calls function must be an "
                                      "object")
                args = fn.get("arguments", "{}")
                if isinstance(args, str):
                    try:
                        args = json.loads(args) if args else {}
                    except json.JSONDecodeError:
                        args = {"raw": args}
                if tc.get("id"):
                    id_to_name[tc["id"]] = fn.get("name", "")
                parts.append("<tool_call>" + json.dumps(
                    {"name": fn.get("name", ""), "arguments": args})
                    + "</tool_call>")
            out.append({"role": "assistant", "content": "".join(parts)})
        elif role == "tool":
            name = (m.get("name")
                    or id_to_name.get(m.get("tool_call_id", ""), "tool"))
            out.append({"role": "tool",
                        "content": format_tool_result(name, content)})
        else:
            out.append({"role": role, "content": content})
    return out


def _inject_tools_prompt(messages: list[dict], specs: list[dict],
                         forced: str | None) -> list[dict]:
    section = tools_system_prompt(specs)
    if forced == "":
        section += "\nYou MUST call one of the tools now."
    elif forced:
        section += f"\nYou MUST call the tool {forced!r} now."
    return inject_tools_section(messages, section)


def _unwrap_agent(engine):
    """Route around the native agent's tool loop for surfaces where the
    CLIENT (or nobody) drives tools. Explicit isinstance: any other
    wrapper that happens to hold an inner .engine must NOT be
    bypassed."""
    from fasttalk_tpu_torch.agents.voice_agent import VoiceAgent

    return engine.engine if isinstance(engine, VoiceAgent) else engine


@contextlib.contextmanager
def _trace_scope(request: web.Request, completion_id: str,
                 session_id: str):
    """Trace-context scope for one /v1 completion (docs/OBSERVABILITY
    .md "Fleet tracing"). An incoming ``traceparent`` header (the
    router's RemoteReplicaHandle dispatch sends one) joins that trace;
    otherwise this edge is the root and mints a fresh trace id. The
    ``request_complete`` terminal event is emitted ONLY at the root —
    a router-dispatched inner hop must not duplicate the one-terminal
    marker stitch() counts."""
    tracer = get_tracer().scoped("serving")
    parsed = parse_traceparent(request.headers.get("traceparent", "")) \
        if propagate_enabled() else None
    inner_hop = parsed is not None
    tid = parsed if parsed else mint_trace_id()
    tracer.start(completion_id, session_id, trace_id=tid)
    with bind_request(completion_id, trace_id=tid):
        try:
            yield
        finally:
            if not inner_hop:
                tracer.event(completion_id, "request_complete")
            tracer.finish(completion_id)


def _oai_tool_call(call, index: int) -> dict:
    return {
        "index": index,
        "id": f"call_{uuid.uuid4().hex[:24]}",
        "type": "function",
        "function": {"name": call.name,
                     "arguments": json.dumps(call.arguments)},
    }


def register_openai_routes(app: web.Application,
                           backend: EngineBase | Callable[[], Any],
                           model_name: str | Callable[[], str],
                           defaults: dict[str, Any] | None = None,
                           breaker: CircuitBreaker | None = None) -> None:
    """``backend`` may be a callable returning the current backend (engine
    or agent — both expose the same generate seam), so the OpenAI route
    goes through the same tool-calling/breaker path as the WebSocket
    route instead of bypassing it."""
    defaults = defaults or {}
    get_backend = backend if callable(backend) else (lambda: backend)
    get_name = model_name if callable(model_name) else (lambda: model_name)

    async def models(request: web.Request) -> web.Response:
        return web.json_response({
            "object": "list",
            "data": [{
                "id": get_name(),
                "object": "model",
                "created": _now(),
                "owned_by": "fasttalk-tpu",
            }],
        })

    def _params(body: dict) -> GenerationParams:
        stop = body.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        ignore_eos = body.get("ignore_eos", False)
        if not isinstance(ignore_eos, bool):
            raise _BadRequest(
                f"ignore_eos must be a boolean, got {ignore_eos!r}")
        return GenerationParams(
            temperature=float(body.get(
                "temperature", defaults.get("temperature", 0.7))),
            top_p=float(body.get("top_p", defaults.get("top_p", 0.9))),
            top_k=int(body.get("top_k", defaults.get("top_k", 40))),
            max_tokens=int(body.get("max_tokens")
                           or body.get("max_completion_tokens")
                           or defaults.get("max_tokens", 1024)),
            stop=[s for s in stop if isinstance(s, str) and s],
            # OpenAI wire names for presence/frequency; repeat_penalty
            # is the Ollama-compatible extension (vLLM's /v1 accepts
            # repetition_penalty — both spellings map to it).
            presence_penalty=float(body.get(
                "presence_penalty",
                defaults.get("presence_penalty", 0.0))),
            frequency_penalty=float(body.get(
                "frequency_penalty",
                defaults.get("frequency_penalty", 0.0))),
            # Key-presence defaulting (NOT an `or` chain): an explicit
            # invalid 0 must surface as a 400 from GenerationParams
            # validation, not be silently swapped for the default.
            repeat_penalty=float(
                body["repeat_penalty"] if "repeat_penalty" in body
                else body["repetition_penalty"]
                if "repetition_penalty" in body
                else defaults.get("repeat_penalty", 1.0)),
            ignore_eos=ignore_eos,
            # Admission-control extensions (docs/SCHEDULING.md):
            # priority class + queue deadline; validated by
            # GenerationParams (bad values → 400, not 500).
            priority=str(body.get("priority",
                                  defaults.get("priority",
                                               "interactive"))),
            deadline_s=(float(body["deadline_s"])
                        if body.get("deadline_s") is not None else None),
        )

    def _breaker_503() -> web.Response | None:
        if breaker is None:
            return None
        try:
            breaker.check()
            return None
        except CircuitBreakerOpen as e:
            return web.json_response(
                {"error": {"message": e.message,
                           "type": "server_error",
                           "retry_after": e.retry_after}}, status=503)

    async def _stream_events(resp, engine, completion_id, session_id,
                             messages, params, handle_token, finalize,
                             write_finish) -> None:
        """The SSE event loop both completion surfaces share: token
        routing, terminal mapping, the error frame (a failed stream ends
        on the error frame + [DONE] with no normal finish chunk, so SDK
        clients can't mistake it for success), breaker accounting, and
        slot release."""
        try:
            finish_reason = "stop"
            failed = False
            shed = False
            async for event in engine.generate(completion_id, session_id,
                                               messages, params):
                if event["type"] == "token":
                    await handle_token(event["text"])
                elif event["type"] in ("done", "cancelled"):
                    finish_reason = _oai_finish(
                        event.get("finish_reason", "stop"))
                elif event["type"] == "resumed":
                    # Fleet failover resumed on a survivor: surface as
                    # an SSE comment line — spec-compliant clients
                    # ignore it, curl-level debugging sees it.
                    await resp.write(
                        f": resumed on {event.get('replica')}\n\n"
                        .encode())
                elif event["type"] == "error":
                    failed = True
                    err_payload = event.get("error")
                    if event.get("code") in ENGINE_SHED_CODES:
                        # Queue-deadline expiry / block-pool
                        # exhaustion = load shedding: the frame keeps
                        # retry_after and the breaker is untouched (a
                        # shed is not a backend fault).
                        shed = True
                        err_payload = AdmissionRejected \
                            .from_shed_event(event).to_dict()
                    await resp.write(
                        f"data: {json.dumps({'error': err_payload})}\n\n"
                        .encode())
                    break
            if not failed:
                finish_reason = await finalize(finish_reason)
            if breaker is not None:
                if failed and not shed:
                    breaker.record_failure()
                elif not failed:
                    breaker.record_success()
            if not failed:
                await write_finish(finish_reason)
            await resp.write(b"data: [DONE]\n\n")
        except AdmissionRejected as e:
            # Shed at admission: the stream is already committed as
            # SSE, so the rejection rides an error frame (to_dict
            # carries retry_after) + [DONE]. NOT a breaker failure —
            # shedding is self-protection, not a backend fault.
            await resp.write(
                f"data: {json.dumps({'error': e.to_dict()})}\n\n"
                .encode())
            await resp.write(b"data: [DONE]\n\n")
        except LLMServiceError as e:
            if e.category != ErrorCategory.VALIDATION:
                if breaker is not None:
                    breaker.record_failure()
                raise
            # Client-shape rejection raised by the engine seam (e.g.
            # an uncompilable structured schema): headers are already
            # committed, so it rides an error frame + [DONE] — and the
            # breaker stays closed, same as the 400 the non-stream
            # path returns.
            await resp.write(
                f"data: {json.dumps({'error': e.to_dict()})}\n\n"
                .encode())
            await resp.write(b"data: [DONE]\n\n")
        except Exception:
            if breaker is not None:
                breaker.record_failure()
            raise
        finally:
            engine.release_session(session_id)

    async def _collect_events(engine, completion_id, session_id, messages,
                              params, on_token):
        """Non-streaming accumulation both surfaces share. Returns
        (stats, finish_reason, error_response_or_None)."""
        stats: dict[str, Any] = {}
        finish_reason = "stop"
        try:
            async for event in engine.generate(completion_id, session_id,
                                               messages, params):
                if event["type"] == "token":
                    on_token(event["text"])
                elif event["type"] in ("done", "cancelled"):
                    stats = event.get("stats", {})
                    finish_reason = _oai_finish(
                        event.get("finish_reason", "stop"))
                elif event["type"] == "error":
                    if event.get("code") in ENGINE_SHED_CODES:
                        # Shed, not a failure: caller maps to 429.
                        raise AdmissionRejected.from_shed_event(event)
                    if breaker is not None:
                        breaker.record_failure()
                    return stats, finish_reason, web.json_response(
                        {"error": {"message": str(event.get("error")),
                                   "type": "server_error"}}, status=500)
            if breaker is not None:
                breaker.record_success()
        except AdmissionRejected:
            raise  # shed, not a backend failure: caller maps to 429
        except LLMServiceError as e:
            if e.category == ErrorCategory.VALIDATION:
                # Client-shape rejection from the engine seam (e.g. an
                # uncompilable structured schema): caller maps to 400;
                # the breaker stays closed.
                raise
            if breaker is not None:
                breaker.record_failure()
            raise
        except Exception:
            if breaker is not None:
                breaker.record_failure()
            raise
        finally:
            engine.release_session(session_id)
        return stats, finish_reason, None

    def _usage(stats: dict) -> dict:
        # `or 0`: remote backends report None when the upstream gave no
        # usage accounting (chunks are never passed off as tokens).
        prompt_tokens = int(stats.get("prompt_tokens") or 0)
        completion_tokens = int(stats.get("tokens_generated") or 0)
        return {"prompt_tokens": prompt_tokens,
                "completion_tokens": completion_tokens,
                "total_tokens": prompt_tokens + completion_tokens}

    async def _sse_response(request: web.Request) -> web.StreamResponse:
        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "keep-alive",
        })
        await resp.prepare(request)
        return resp

    async def chat_completions(request: web.Request) -> web.StreamResponse:
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return web.json_response(
                {"error": {"message": "invalid JSON body",
                           "type": "invalid_request_error"}}, status=400)
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            return web.json_response(
                {"error": {"message": "messages must be a non-empty list",
                           "type": "invalid_request_error"}}, status=400)
        try:
            params = _params(body)
            specs, forced = _parse_tools(body)
            # Structured output (docs/STRUCTURED.md): response_format
            # compiles to a token-FSM constraint; unsupported combos
            # 400 here with the clash named.
            params.structured = _parse_response_format(body)
            _check_structured_combos(body, params.structured, specs)
        except (_BadRequest, TypeError, ValueError) as e:
            return web.json_response(
                {"error": {"message": str(e),
                           "type": "invalid_request_error"}}, status=400)
        completion_id = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        created = _now()
        session_id = body.get("user") or f"oai-{completion_id}"
        req_model = body.get("model", get_name())
        engine = get_backend()
        if specs:
            # Client-declared tools mean the CLIENT drives the tool loop
            # (PydanticAI-style). If the configured backend is the native
            # agent, unwrap to the bare engine — otherwise the agent's
            # own hermes loop would strip the markup and execute calls
            # against the server-side registry before this route's parser
            # ever saw them. Explicit isinstance: any other wrapper that
            # happens to hold an inner .engine must NOT be bypassed.
            engine = _unwrap_agent(engine)
        # Passthrough (remote OpenAI/Ollama) backends get the messages
        # VERBATIM: rewriting role-"tool" turns into hermes markup would
        # drop tool_call_id, and strict OpenAI-schema upstreams reject
        # multi-turn tool conversations without it (ADVICE r2). Only the
        # in-tree engine needs the hermes form its templates render.
        # Detect on the UNWRAPPED backend: with no tools declared this
        # turn, `engine` may still be the agent wrapping a remote.
        if not isinstance(_unwrap_agent(engine), _RemoteEngine):
            try:
                messages = _hermes_messages(messages)
            except (_BadRequest, TypeError, ValueError) as e:
                return web.json_response(
                    {"error": {"message": str(e),
                               "type": "invalid_request_error"}},
                    status=400)
        if specs:
            messages = _inject_tools_prompt(messages, specs, forced)
        if forced is not None and params.structured is None \
                and not isinstance(_unwrap_agent(engine), _RemoteEngine) \
                and not params.stop \
                and _structured_denied(engine) is None:
            # tool_choice forced a call: constrain the whole completion
            # to hermes tool-call markup whose *arguments* validate
            # against the tool's parameter schema — the call cannot be
            # malformed (docs/STRUCTURED.md). In-tree engine only;
            # remote upstreams bring their own tool enforcement. The
            # constraint is an internal upgrade the client never asked
            # for, so when this engine build cannot serve constraints
            # (mesh/Pallas/STRUCTURED_MODE=off) — or client stop
            # sequences would clash with the grammar — the request
            # falls back to the pre-existing prompt-injection +
            # stream-parser path instead of being rejected.
            if body.get("ignore_eos"):
                # Same clash the response_format path 400s on: the
                # grammar decides where the call ends. Enforced here
                # because the constraint is attached after _params()
                # ran GenerationParams' own validation.
                return web.json_response(
                    {"error": {"message":
                               "a forcing tool_choice is incompatible "
                               "with ignore_eos=true (the tool-call "
                               "grammar decides where the completion "
                               "ends)",
                               "type": "invalid_request_error"}},
                    status=400)
            params.structured = validate_structured_spec({
                "kind": "tool_call",
                "tools": [{"name": s["name"],
                           "parameters": s["parameters"]}
                          for s in specs
                          if forced == "" or s["name"] == forced]})
        if params.structured is not None:
            reason = _structured_denied(engine)
            if reason is not None:
                return web.json_response(
                    {"error": {"message": "structured output "
                               f"unavailable: {reason}",
                               "type": "invalid_request_error"}},
                    status=400)
        parser = HermesStreamParser() if specs else None
        denied = _breaker_503()
        if denied is not None:
            return denied

        if body.get("stream"):
            resp = await _sse_response(request)

            def chunk(delta: dict, finish: str | None = None) -> bytes:
                payload = {
                    "id": completion_id, "object": "chat.completion.chunk",
                    "created": created, "model": req_model,
                    "choices": [{"index": 0, "delta": delta,
                                 "finish_reason": finish}],
                }
                return f"data: {json.dumps(payload)}\n\n".encode()

            await resp.write(chunk({"role": "assistant"}))
            n_calls = 0

            async def handle_token(text: str) -> None:
                nonlocal n_calls
                if parser is None:
                    await resp.write(chunk({"content": text}))
                    return
                text, calls = parser.feed(text)
                if text:
                    await resp.write(chunk({"content": text}))
                for call in calls:
                    if not call.name:
                        continue  # malformed markup: drop
                    await resp.write(chunk({"tool_calls": [
                        _oai_tool_call(call, n_calls)]}))
                    n_calls += 1

            async def finalize(finish_reason: str) -> str:
                if parser is not None:
                    tail = parser.flush()
                    if tail:
                        await resp.write(chunk({"content": tail}))
                    if n_calls:
                        return "tool_calls"
                return finish_reason

            async def write_finish(finish_reason: str) -> None:
                await resp.write(chunk({}, finish=finish_reason))

            with _trace_scope(request, completion_id, session_id):
                await _stream_events(resp, engine, completion_id,
                                     session_id, messages, params,
                                     handle_token, finalize,
                                     write_finish)
            return resp

        # Non-streaming
        text = ""
        tool_calls: list[dict] = []

        def on_token(t: str) -> None:
            nonlocal text
            if parser is None:
                text += t
                return
            piece, calls = parser.feed(t)
            text += piece
            tool_calls.extend(_oai_tool_call(c, len(tool_calls))
                              for c in calls if c.name)

        try:
            with _trace_scope(request, completion_id, session_id):
                stats, finish_reason, err = await _collect_events(
                    engine, completion_id, session_id, messages, params,
                    on_token)
        except AdmissionRejected as e:
            return _reject_429(e)
        except LLMServiceError as e:
            if e.category != ErrorCategory.VALIDATION:
                raise
            return web.json_response(
                {"error": {"message": e.message,
                           "type": "invalid_request_error"}},
                status=400)
        if err is not None:
            return err
        if parser is not None:
            text += parser.flush()
            if tool_calls:
                finish_reason = "tool_calls"
        message: dict[str, Any] = {"role": "assistant",
                                   "content": text or None}
        if tool_calls:
            message["tool_calls"] = tool_calls
        return web.json_response({
            "id": completion_id,
            "object": "chat.completion",
            "created": created,
            "model": req_model,
            "choices": [{
                "index": 0,
                "message": message,
                "finish_reason": finish_reason,
            }],
            "usage": _usage(stats),
        })

    async def completions(request: web.Request) -> web.StreamResponse:
        """Legacy text completions (/v1/completions): raw prompt, no
        chat template, no tools — vLLM served both surfaces and some
        ecosystem tooling still speaks this one."""
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return web.json_response(
                {"error": {"message": "invalid JSON body",
                           "type": "invalid_request_error"}}, status=400)
        prompt = body.get("prompt")
        if isinstance(prompt, list):
            if len(prompt) != 1 or not isinstance(prompt[0], str):
                return web.json_response(
                    {"error": {"message": "prompt must be a string (or a "
                               "single-element list of strings)",
                               "type": "invalid_request_error"}}, status=400)
            prompt = prompt[0]
        if not isinstance(prompt, str) or not prompt:
            return web.json_response(
                {"error": {"message": "prompt must be a non-empty string",
                           "type": "invalid_request_error"}}, status=400)
        try:
            params = _params(body)
            params.structured = _parse_response_format(body)
            _check_structured_combos(body, params.structured)
        except (_BadRequest, TypeError, ValueError) as e:
            return web.json_response(
                {"error": {"message": str(e),
                           "type": "invalid_request_error"}}, status=400)
        params.raw_prompt = True  # out-of-band: no template, BOS + bytes
        if (body.get("max_tokens") is None
                and body.get("max_completion_tokens") is None):
            # The legacy endpoint's spec default is 16 (vLLM matches);
            # inheriting the chat default (2048) would surprise clients
            # migrating from a vLLM deployment.
            params.max_tokens = 16
        completion_id = f"cmpl-{uuid.uuid4().hex[:24]}"
        created = _now()
        session_id = body.get("user") or f"oai-{completion_id}"
        req_model = body.get("model", get_name())
        # The raw path never goes through an agent's tool loop.
        engine = _unwrap_agent(get_backend())
        messages = [{"role": "user", "content": prompt}]
        if params.structured is not None:
            reason = _structured_denied(engine)
            if reason is not None:
                return web.json_response(
                    {"error": {"message": "structured output "
                               f"unavailable: {reason}",
                               "type": "invalid_request_error"}},
                    status=400)
        denied = _breaker_503()
        if denied is not None:
            return denied

        if body.get("stream"):
            resp = await _sse_response(request)

            def chunk(text: str, finish: str | None = None) -> bytes:
                payload = {
                    "id": completion_id, "object": "text_completion",
                    "created": created, "model": req_model,
                    "choices": [{"index": 0, "text": text,
                                 "finish_reason": finish}],
                }
                return f"data: {json.dumps(payload)}\n\n".encode()

            async def handle_token(text: str) -> None:
                await resp.write(chunk(text))

            async def finalize(finish_reason: str) -> str:
                return finish_reason

            async def write_finish(finish_reason: str) -> None:
                await resp.write(chunk("", finish=finish_reason))

            with _trace_scope(request, completion_id, session_id):
                await _stream_events(resp, engine, completion_id,
                                     session_id, messages, params,
                                     handle_token, finalize,
                                     write_finish)
            return resp

        text = ""

        def on_token(t: str) -> None:
            nonlocal text
            text += t

        try:
            with _trace_scope(request, completion_id, session_id):
                stats, finish_reason, err = await _collect_events(
                    engine, completion_id, session_id, messages, params,
                    on_token)
        except AdmissionRejected as e:
            return _reject_429(e)
        except LLMServiceError as e:
            if e.category != ErrorCategory.VALIDATION:
                raise
            return web.json_response(
                {"error": {"message": e.message,
                           "type": "invalid_request_error"}},
                status=400)
        if err is not None:
            return err
        return web.json_response({
            "id": completion_id,
            "object": "text_completion",
            "created": created,
            "model": req_model,
            "choices": [{"index": 0, "text": text,
                         "finish_reason": finish_reason}],
            "usage": _usage(stats),
        })

    app.router.add_get("/v1/models", models)
    app.router.add_post("/v1/chat/completions", chat_completions)
    app.router.add_post("/v1/completions", completions)


def _oai_finish(reason: str) -> str:
    return {"stop": "stop", "length": "length", "cancelled": "stop",
            "tool_rounds": "stop"}.get(reason, "stop")
