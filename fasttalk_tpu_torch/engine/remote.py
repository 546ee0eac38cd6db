"""Legacy remote backends behind the engine seam: vLLM and Ollama.

Back-compat parity with the reference's L1 handler layer — the vLLM
OpenAI-SSE client (app/core/vllm_handler.py:117-308) and the Ollama
NDJSON client (app/core/ollama_handler.py:110-339) — rebuilt as
EngineBase implementations so the serving layer is provider-pluggable
(tpu | vllm | ollama) exactly as SURVEY.md §7 prescribes. Fully async
(aiohttp): no sync-generator-in-async-loop stalls (reference flaw,
SURVEY.md §3.3), and cancellation closes the HTTP stream immediately.

The port's copy of ``fasttalk_tpu/engine/remote.py`` (imports only).
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Any, AsyncGenerator

import aiohttp

from fasttalk_tpu_torch.engine.engine import (EngineBase, GenerationParams,
                                              raw_prompt_text)
from fasttalk_tpu_torch.observability.trace import (current_traceparent,
                                                    get_tracer)
from fasttalk_tpu_torch.resilience import failpoints as _fp
from fasttalk_tpu_torch.utils.errors import (AdmissionRejected, ErrorCategory,
                                             LLMServiceError)
from fasttalk_tpu_torch.utils.logger import get_logger
from fasttalk_tpu_torch.utils.metrics import get_metrics

log = get_logger("engine.remote")


class _RemoteEngine(EngineBase):
    """Shared plumbing: lazy client session, cancel flags, lifecycle,
    and bounded upstream concurrency — at most ``max_inflight``
    requests stream from the backend at once, so the backpressure and
    shedding discipline of the TPU branch (docs/SCHEDULING.md) applies
    uniformly here: a waiter that cannot start within
    ``admission_timeout_s`` is shed with AdmissionRejected +
    retry_after instead of piling onto a saturated upstream."""

    def __init__(self, base_url: str, timeout_s: float = 600.0,
                 max_inflight: int = 32,
                 admission_timeout_s: float = 30.0,
                 connect_retries: int = 2):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        self.max_inflight = max(1, max_inflight)
        self.admission_timeout_s = admission_timeout_s
        # Bounded retries for idempotent upstream failures: a connect
        # error or 5xx BEFORE the first streamed chunk left nothing
        # client-visible, so retrying is safe; after the first chunk a
        # failure surfaces (the fleet router owns mid-stream recovery).
        self.connect_retries = max(0, connect_retries)
        self._sem = asyncio.Semaphore(self.max_inflight)
        self._inflight = 0
        self._draining = False
        self._cancelled: set[str] = set()
        self._session: aiohttp.ClientSession | None = None
        self._started = False
        self._tracer = get_tracer()
        m = get_metrics()
        self._m_shed = m.counter(
            "remote_shed_total",
            "remote-backend submissions shed (upstream saturated past "
            "the admission timeout, or draining)")
        self._m_inflight = m.gauge(
            "remote_inflight_requests",
            "requests currently streaming from the remote backend")
        self._m_retries = m.counter(
            "remote_connect_retries_total",
            "pre-first-token upstream failures retried (connect "
            "errors and 5xx before any output)")

    def _connect_retry_delay(self, attempt: int, chunks: int,
                             ) -> float | None:
        """Backoff before retrying a pre-first-token upstream failure,
        or None when the failure must surface: something was already
        streamed (the retry is no longer idempotent) or the bounded
        attempts are exhausted. Jittered exponential, capped at 2 s —
        the same shape as the serving layer's RetryManager, scaled for
        a client inside a live request."""
        import random

        if chunks > 0 or attempt >= self.connect_retries:
            return None
        base = min(2.0, 0.25 * (2 ** attempt))
        return base * (1.0 + random.uniform(-0.25, 0.25))

    def _upstream_retry_delay(self, e: BaseException, attempt: int,
                              chunks: int, request_id: str,
                              name: str) -> float:
        """Classify one streaming failure: return the backoff delay
        when it is a retryable pre-first-token failure (connect error
        or upstream 5xx with nothing streamed), or raise what must
        surface — a 4xx is the request's fault and will 4xx again, and
        anything after the first chunk is no longer idempotent. Shared
        by every provider client so the idempotency rule cannot drift
        between them."""
        is_5xx = (isinstance(e, LLMServiceError)
                  and e.details.get("status", 0) >= 500)
        if isinstance(e, LLMServiceError) and not is_5xx:
            raise e
        delay = self._connect_retry_delay(attempt, chunks)
        if delay is None:
            if isinstance(e, LLMServiceError):
                e.retry_after = e.retry_after or 2.0
                raise e
            raise LLMServiceError(
                f"{name} connection failed: {e}",
                category=ErrorCategory.CONNECTION,
                retry_after=2.0) from e
        self._m_retries.inc()
        log.warning(f"[{request_id}] upstream failed pre-first-token "
                    f"({e}); retry {attempt + 1}/"
                    f"{self.connect_retries} in {delay:.2f}s")
        return delay

    async def _acquire_upstream(self) -> None:
        """Take an upstream slot or shed. Raises AdmissionRejected when
        draining or when ``max_inflight`` streams are already running
        and none frees up within the admission timeout."""
        if self._draining:
            self._m_shed.inc()
            raise AdmissionRejected(
                "server is draining: finishing in-flight requests, not "
                "accepting new ones", retry_after=5.0, reason="draining")
        try:
            await asyncio.wait_for(self._sem.acquire(),
                                   timeout=self.admission_timeout_s)
        except asyncio.TimeoutError:
            self._m_shed.inc()
            raise AdmissionRejected(
                f"upstream at capacity ({self.max_inflight} requests in "
                f"flight for {self.admission_timeout_s:.0f}s)",
                retry_after=min(30.0, max(1.0,
                                          self.admission_timeout_s / 4)),
                reason="upstream_saturated") from None
        self._inflight += 1
        self._m_inflight.set(self._inflight)

    def _release_upstream(self) -> None:
        self._inflight -= 1
        self._m_inflight.set(self._inflight)
        self._sem.release()

    def begin_drain(self) -> None:
        self._draining = True

    def pending_requests(self) -> int:
        return self._inflight

    def start(self) -> None:
        self._started = True

    def shutdown(self) -> None:
        self._started = False
        session, self._session = self._session, None
        if session is not None and not session.closed:
            try:
                loop = asyncio.get_event_loop()
                if loop.is_running():
                    loop.create_task(session.close())
                else:
                    loop.run_until_complete(session.close())
            except RuntimeError:
                pass

    async def _client(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=self.timeout_s,
                                              sock_connect=10))
        return self._session

    def cancel(self, request_id: str) -> bool:
        self._cancelled.add(request_id)
        return True

    def release_session(self, session_id: str) -> None:
        pass  # remote backends hold no per-session device state

    def get_stats(self) -> dict:
        return {"backend": self.base_url,
                "cancelled_pending": len(self._cancelled),
                "inflight": self._inflight,
                "max_inflight": self.max_inflight,
                "draining": self._draining}

    def _sync_get(self, url: str, timeout: float = 3.0) -> Any:
        import requests

        r = requests.get(url, timeout=timeout)
        r.raise_for_status()
        return r

    def _trace_start(self, request_id: str, session_id: str,
                     backend: str) -> bool:
        """Register the request with the span tracer (phase: upstream).
        Returns whether this engine owns the trace's finish (False when
        the serving layer started it first)."""
        tracer = self._tracer
        owned = tracer.start(request_id, session_id)
        tracer.set_phase(request_id, "upstream", backend=backend)
        return owned

    def set_trace_component(self, component: str) -> None:
        """Tag this engine's spans with a fleet component name (see
        EngineBase.set_trace_component)."""
        self._tracer = get_tracer().scoped(component)

    def _trace_end(self, request_id: str, owned: bool, t0: float,
                   ttft_ms: float | None, chunks: int,
                   backend: str) -> None:
        """Close the upstream_stream span (covers connect + the whole
        body read — a remote engine has no queue/prefill visibility, so
        this is the request's single engine-side phase)."""
        tracer = self._tracer
        tracer.add_span(request_id, "upstream_stream", t0,
                        time.monotonic(), summary=True, backend=backend,
                        chunks=chunks,
                        **({"ttft_ms": round(ttft_ms, 3)}
                           if ttft_ms is not None else {}))
        if owned:
            tracer.finish(request_id)

    def _finish_stats(self, chunks: int, started: float,
                      ttft: float | None,
                      prompt_tokens: int | None = None,
                      completion_tokens: int | None = None) -> dict:
        """Terminal stats for a remote stream.

        A stream CHUNK is not a token (the reference conflated the two —
        SURVEY.md §5 metrics gap, explicitly on the don't-copy list), so
        ``tokens_generated``/``tokens_per_second`` are reported only when
        the backend supplied its own authoritative token counts (vLLM
        usage via stream_options, Ollama eval_count); otherwise they are
        None and ``chunks_generated`` carries the honestly-labelled
        chunk count."""
        dur = time.monotonic() - started
        return {
            "chunks_generated": chunks,
            "tokens_generated": completion_tokens,
            "processing_time_ms": dur * 1000,
            "tokens_per_second": (completion_tokens / dur
                                  if completion_tokens is not None
                                  and dur > 0 else None),
            "ttft_ms": ttft,
            "prompt_tokens": prompt_tokens,
        }


class VLLMRemoteEngine(_RemoteEngine):
    """OpenAI-compatible SSE streaming client against an external vLLM
    (reference: vllm_handler.py — base URL config at config.py:96)."""

    def __init__(self, base_url: str, model: str,
                 api_key: str = "not-needed", timeout_s: float = 600.0,
                 max_inflight: int = 32,
                 admission_timeout_s: float = 30.0,
                 connect_retries: int = 2):
        super().__init__(base_url, timeout_s, max_inflight=max_inflight,
                         admission_timeout_s=admission_timeout_s,
                         connect_retries=connect_retries)
        self.model = model
        self.api_key = api_key
        # Set after a backend 400s on stream_options (pre-0.4.3 vLLM,
        # strict OpenAI-compatible proxies): dropped for the engine's
        # lifetime; stats then fall back to chunk counting.
        self._no_stream_options = False
        # Same lifecycle for repetition_penalty: vLLM accepts it as a
        # sampling extension, but strict OpenAI-compatible backends 400
        # on the unknown param — drop it (not the request) and retry.
        self._no_repetition_penalty = False

    async def generate(self, request_id: str, session_id: str,
                       messages: list[dict], params: GenerationParams,
                       ) -> AsyncGenerator[dict, None]:
        client = await self._client()
        body = {
            "model": self.model,
            "temperature": params.temperature,
            "top_p": params.top_p,
            "max_tokens": params.max_tokens,
            "stream": True,
            # OpenAI-style penalties pass straight through.
            "presence_penalty": params.presence_penalty,
            "frequency_penalty": params.frequency_penalty,
        }
        if params.repeat_penalty != 1.0 and not self._no_repetition_penalty:
            body["repetition_penalty"] = params.repeat_penalty
        if params.structured is not None:
            # Structured passthrough (docs/STRUCTURED.md): the JSON
            # kinds map onto the upstream's own response_format; kinds
            # the OpenAI wire protocol cannot express fail loudly —
            # silently serving unconstrained output would break the
            # validity contract the client asked for.
            kind = params.structured.get("kind")
            if kind == "json_object":
                body["response_format"] = {"type": "json_object"}
            elif kind == "json_schema":
                body["response_format"] = {
                    "type": "json_schema",
                    "json_schema": {"name": "response", "strict": True,
                                    "schema":
                                        params.structured["schema"]}}
            else:
                raise LLMServiceError(
                    f"structured kind {kind!r} cannot pass through an "
                    "OpenAI-compatible upstream (json_object/"
                    "json_schema only)",
                    category=ErrorCategory.VALIDATION,
                    recoverable=False)
        if not self._no_stream_options:
            # Ask the backend for its own token accounting (an OpenAI /
            # vLLM-supported option): the final chunk then carries
            # usage.completion_tokens, the only true token count a
            # remote client can get (chunk != token, SURVEY.md §5).
            body["stream_options"] = {"include_usage": True}
        if params.raw_prompt:
            # /v1/completions passthrough: raw prompt, upstream's own
            # legacy endpoint (no chat template anywhere).
            url = f"{self.base_url}/completions"
            body["prompt"] = raw_prompt_text(messages)
        else:
            url = f"{self.base_url}/chat/completions"
            body["messages"] = messages
        if params.stop:
            body["stop"] = params.stop
        started = time.monotonic()
        ttft = None
        chunks = 0
        prompt_toks: int | None = None
        completion_toks: int | None = None
        finish = "stop"
        await self._acquire_upstream()
        trace_owned = self._trace_start(request_id, session_id, "vllm")
        retry_attempt = 0
        try:
            while True:  # pre-first-token connect/5xx retry loop
                try:
                    if _fp.enabled:
                        # Chaos seam: raised as the transport error
                        # type so the pre-first-token retry (and the
                        # router's replica-fault classifier) treat it
                        # exactly like a real connect failure.
                        await _fp.fire_async("remote.connect",
                                 exc=aiohttp.ClientConnectionError,
                                 request_id=request_id)
                    # Trace-context propagation (docs/OBSERVABILITY.md
                    # "Fleet tracing"): carry the fleet trace id on the
                    # dispatch so a remote replica's serving edge joins
                    # its spans to the router's trace instead of
                    # minting a disjoint one.
                    headers = {"Authorization": f"Bearer {self.api_key}"}
                    tp = current_traceparent()
                    if tp is not None:
                        headers["traceparent"] = tp
                    for _attempt in range(3):
                        async with client.post(
                                url, json=body, headers=headers,
                                ) as resp:
                            if resp.status != 200:
                                text = await resp.text()
                                if resp.status == 400 \
                                        and "stream_options" in body \
                                        and "stream_options" in text:
                                    # The backend names stream_options
                                    # in its 400 (pre-0.4.3 vLLM,
                                    # strict proxies): drop the
                                    # parameter for this engine's
                                    # lifetime and retry once (stats
                                    # degrade to honest chunk counts).
                                    # Any OTHER 400 — context overflow,
                                    # bad params — surfaces unretried
                                    # below.
                                    self._no_stream_options = True
                                    del body["stream_options"]
                                    continue
                                if resp.status == 400 \
                                        and "repetition_penalty" in body \
                                        and "repetition_penalty" in text:
                                    # Strict OpenAI-compatible backend
                                    # without the vLLM sampling
                                    # extension: serve without the
                                    # penalty rather than failing every
                                    # generation.
                                    self._no_repetition_penalty = True
                                    del body["repetition_penalty"]
                                    continue
                                err = LLMServiceError(
                                    f"vLLM backend error {resp.status}: "
                                    f"{text[:200]}",
                                    category=ErrorCategory.CONNECTION,
                                    details={"status": resp.status})
                                raise err
                            async for raw in resp.content:
                                if _fp.enabled:
                                    # Mid-stream failure: chunks > 0
                                    # makes the retry non-idempotent,
                                    # so this must surface terminally.
                                    await _fp.fire_async("remote.stream",
                                             exc=aiohttp.ClientError,
                                             request_id=request_id)
                                if request_id in self._cancelled:
                                    self._cancelled.discard(request_id)
                                    yield {"type": "cancelled",
                                           "finish_reason": "cancelled",
                                           "stats": self._finish_stats(
                                               chunks, started, ttft,
                                               prompt_toks,
                                               completion_toks)}
                                    return
                                line = raw.decode("utf-8",
                                                  "replace").strip()
                                if not line.startswith("data:"):
                                    continue
                                payload = line[5:].strip()
                                if payload == "[DONE]":
                                    break
                                try:
                                    obj = json.loads(payload)
                                except json.JSONDecodeError:
                                    continue
                                usage = obj.get("usage")
                                if usage:
                                    # include_usage final chunk (empty
                                    # choices): backend-authoritative
                                    # token counts.
                                    prompt_toks = usage.get(
                                        "prompt_tokens", prompt_toks)
                                    completion_toks = usage.get(
                                        "completion_tokens",
                                        completion_toks)
                                choices = obj.get("choices") or []
                                if not choices:
                                    continue
                                fr = choices[0].get("finish_reason")
                                if fr:
                                    finish = fr
                                # chat streams deltas; completions
                                # streams text
                                content = (choices[0].get("text")
                                           if params.raw_prompt
                                           else choices[0].get("delta",
                                                               {})
                                           .get("content"))
                                if content:
                                    chunks += 1
                                    if ttft is None:
                                        ttft = (time.monotonic()
                                                - started) * 1000
                                        self._tracer.event(request_id,
                                                           "first_chunk")
                                    yield {"type": "token",
                                           "text": content}
                        break  # stream consumed; no param retry
                    break  # success: leave the connect-retry loop
                except (aiohttp.ClientError, asyncio.TimeoutError,
                        LLMServiceError) as e:
                    delay = self._upstream_retry_delay(
                        e, retry_attempt, chunks, request_id, "vLLM")
                    retry_attempt += 1
                    await asyncio.sleep(delay)
            yield {"type": "done", "finish_reason": finish,
                   "stats": self._finish_stats(chunks, started, ttft,
                                               prompt_toks,
                                               completion_toks)}
        finally:
            self._release_upstream()
            self._trace_end(request_id, trace_owned, started, ttft,
                            chunks, "vllm")
            self._cancelled.discard(request_id)

    def check_connection(self) -> bool:
        if not self._started:
            return False
        try:
            root = self.base_url.rsplit("/v1", 1)[0]
            self._sync_get(f"{root}/health")
            return True
        except Exception:
            return False

    def get_model_info(self) -> dict:
        # Static (no network): this runs inside async handlers, where a
        # blocking round-trip would stall the event loop.
        return {"model": self.model, "backend": "vllm",
                "base_url": self.base_url}

    def list_available_models(self) -> list[str]:
        """Network call — do not use from the event loop."""
        try:
            r = self._sync_get(f"{self.base_url}/models")
            return [m.get("id") for m in r.json().get("data", [])]
        except Exception:
            return []


class OllamaRemoteEngine(_RemoteEngine):
    """NDJSON streaming client against an external Ollama
    (reference: ollama_handler.py — base URL config at config.py:116)."""

    def __init__(self, base_url: str, model: str,
                 keep_alive: str = "5m", timeout_s: float = 600.0,
                 max_inflight: int = 32,
                 admission_timeout_s: float = 30.0,
                 connect_retries: int = 2):
        super().__init__(base_url, timeout_s, max_inflight=max_inflight,
                         admission_timeout_s=admission_timeout_s,
                         connect_retries=connect_retries)
        self.model = model
        self.keep_alive = keep_alive

    async def generate(self, request_id: str, session_id: str,
                       messages: list[dict], params: GenerationParams,
                       ) -> AsyncGenerator[dict, None]:
        client = await self._client()
        body = {
            "model": self.model,
            "stream": True,
            "keep_alive": self.keep_alive,
            "options": {
                "temperature": params.temperature,
                "top_p": params.top_p,
                "top_k": params.top_k,
                "num_predict": params.max_tokens,
                # Explicit where the reference's gateway relied on the
                # engine default (~1.1): the applied penalty is now in
                # the request record, not implicit engine state.
                "repeat_penalty": params.repeat_penalty,
                "presence_penalty": params.presence_penalty,
                "frequency_penalty": params.frequency_penalty,
            },
        }
        if params.raw_prompt:
            # /api/generate with raw=true: Ollama's untemplated path.
            url = f"{self.base_url}/api/generate"
            body["prompt"] = raw_prompt_text(messages)
            body["raw"] = True
        else:
            url = f"{self.base_url}/api/chat"
            body["messages"] = messages
        if params.stop:
            body["options"]["stop"] = params.stop
        if params.structured is not None:
            # Ollama's structured-outputs surface: format="json" for
            # the generic contract, format=<schema> for a JSON Schema.
            # Other kinds cannot be expressed — fail loudly rather
            # than silently dropping the constraint.
            kind = params.structured.get("kind")
            if kind == "json_object":
                body["format"] = "json"
            elif kind == "json_schema":
                body["format"] = params.structured["schema"]
            else:
                raise LLMServiceError(
                    f"structured kind {kind!r} cannot pass through an "
                    "Ollama upstream (json_object/json_schema only)",
                    category=ErrorCategory.VALIDATION,
                    recoverable=False)
        started = time.monotonic()
        ttft = None
        chunks = 0
        prompt_toks: int | None = None
        completion_toks: int | None = None
        await self._acquire_upstream()
        trace_owned = self._trace_start(request_id, session_id, "ollama")
        retry_attempt = 0
        try:
            while True:  # pre-first-token connect/5xx retry loop
                try:
                    if _fp.enabled:
                        await _fp.fire_async("remote.connect",
                                 exc=aiohttp.ClientConnectionError,
                                 request_id=request_id)
                    tp = current_traceparent()
                    async with client.post(
                            url, json=body,
                            headers={"traceparent": tp} if tp else None,
                            ) as resp:
                        if resp.status != 200:
                            text = await resp.text()
                            raise LLMServiceError(
                                f"Ollama backend error {resp.status}: "
                                f"{text[:200]}",
                                category=ErrorCategory.CONNECTION,
                                details={"status": resp.status})
                        async for raw in resp.content:
                            if _fp.enabled:
                                await _fp.fire_async("remote.stream",
                                         exc=aiohttp.ClientError,
                                         request_id=request_id)
                            if request_id in self._cancelled:
                                self._cancelled.discard(request_id)
                                yield {"type": "cancelled",
                                       "finish_reason": "cancelled",
                                       "stats": self._finish_stats(
                                           chunks, started, ttft,
                                           prompt_toks, completion_toks)}
                                return
                            line = raw.decode("utf-8", "replace").strip()
                            if not line:
                                continue
                            try:
                                obj = json.loads(line)
                            except json.JSONDecodeError:
                                continue
                            # /api/chat nests under message;
                            # /api/generate is flat
                            content = (obj.get("response")
                                       if params.raw_prompt
                                       else (obj.get("message") or {})
                                       .get("content"))
                            if content:
                                chunks += 1
                                if ttft is None:
                                    ttft = (time.monotonic()
                                            - started) * 1000
                                    self._tracer.event(request_id,
                                                       "first_chunk")
                                yield {"type": "token", "text": content}
                            if obj.get("done"):
                                # Final NDJSON object carries Ollama's
                                # own token accounting (the reference
                                # threw these away and counted chunks,
                                # ollama_handler.py:233-339).
                                prompt_toks = obj.get(
                                    "prompt_eval_count", prompt_toks)
                                completion_toks = obj.get(
                                    "eval_count", completion_toks)
                                break
                    break  # success: leave the connect-retry loop
                except (aiohttp.ClientError, asyncio.TimeoutError,
                        LLMServiceError) as e:
                    delay = self._upstream_retry_delay(
                        e, retry_attempt, chunks, request_id, "Ollama")
                    retry_attempt += 1
                    await asyncio.sleep(delay)
            yield {"type": "done", "finish_reason": "stop",
                   "stats": self._finish_stats(chunks, started, ttft,
                                               prompt_toks,
                                               completion_toks)}
        finally:
            self._release_upstream()
            self._trace_end(request_id, trace_owned, started, ttft,
                            chunks, "ollama")
            self._cancelled.discard(request_id)

    def check_connection(self) -> bool:
        if not self._started:
            return False
        try:
            self._sync_get(f"{self.base_url}/")
            return True
        except Exception:
            return False

    def get_model_info(self) -> dict:
        # Static (no network): see VLLMRemoteEngine.get_model_info.
        return {"model": self.model, "backend": "ollama",
                "base_url": self.base_url}

    def list_available_models(self) -> list[str]:
        """Network call — do not use from the event loop."""
        try:
            r = self._sync_get(f"{self.base_url}/api/tags")
            return [m.get("name") for m in r.json().get("models", [])]
        except Exception:
            return []
