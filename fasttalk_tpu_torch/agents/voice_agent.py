"""The native tool-calling agent: detect → execute → resume, in-stream.

Replaces the reference's PydanticAI agent (app/agents/voice_agent.py:
85-344, whose tool loop lived inside the pydantic_ai library and whose
parsing lived inside vLLM's --tool-call-parser flag) with a loop this
framework owns end to end, running directly on the in-process engine:

  1. prepend a hermes-format tool section to the system prompt,
  2. stream from the engine while the HermesStreamParser scans deltas,
  3. on a completed <tool_call>: suppress its markup, emit a tool_call
     event (so clients can render activity), execute via the registry,
     append the call + <tool_response> to the message list, and resume
     generation with the grown history — the engine's prefix-reuse makes
     the resume prefill only the delta,
  4. bounded by max_tool_rounds to prevent loops.

Exposes the same event-stream seam as EngineBase, so the serving layer
treats agent and bare engine identically.

The port's copy of ``fasttalk_tpu/agents/voice_agent.py`` (imports only).
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, AsyncGenerator

from fasttalk_tpu_torch.agents.hermes import (
    HermesStreamParser,
    format_tool_result,
    inject_tools_section,
    tools_system_prompt,
)
from fasttalk_tpu_torch.agents.tools import ToolRegistry, build_default_registry
from fasttalk_tpu_torch.engine.engine import EngineBase, GenerationParams
from fasttalk_tpu_torch.utils.logger import get_logger
from fasttalk_tpu_torch.utils.metrics import get_metrics

log = get_logger("agents.voice_agent")


class VoiceAgent:
    def __init__(self, engine: EngineBase, config: Any = None,
                 registry: ToolRegistry | None = None,
                 max_tool_rounds: int = 4):
        self.engine = engine
        self.max_tool_rounds = max_tool_rounds
        if registry is not None:
            self.registry = registry
        else:
            from fasttalk_tpu_torch.agents.search import backend_from_config

            enable_search = bool(getattr(config, "enable_web_search", True))
            rate = float(getattr(config, "web_search_rate_limit", 1.0))
            self.registry = build_default_registry(
                enable_web_search=enable_search,
                search_backend=(backend_from_config(config)
                                if enable_search else None),
                search_rate_limit_s=rate)
        self._m_calls = get_metrics().counter(
            "agent_tool_calls_total", "tool calls executed by the agent")
        # top-level request id -> currently running engine sub-request id,
        # so cancel(top_id) reaches the live engine request.
        self._active_sub: dict[str, str] = {}

    def update_config(self, **overrides: Any) -> None:
        if "max_tool_rounds" in overrides:
            self.max_tool_rounds = int(overrides["max_tool_rounds"])

    def _augment_system(self, messages: list[dict]) -> list[dict]:
        specs = self.registry.specs()
        if not specs:
            return messages
        return inject_tools_section(messages, tools_system_prompt(specs))

    async def generate(self, request_id: str, session_id: str,
                       messages: list[dict], params: GenerationParams,
                       ) -> AsyncGenerator[dict, None]:
        """Event stream: token / tool_call / done|cancelled|error.

        Same seam as EngineBase.generate, so the server swaps it in
        transparently.
        """
        msgs = self._augment_system(messages)
        context = {"session_id": session_id,
                   "turns": sum(1 for m in messages
                                if m.get("role") == "user"),
                   "started_at": time.time()}
        agg_stats: dict[str, Any] = {"tokens_generated": 0,
                                     "prompt_tokens": 0}
        started = time.monotonic()
        ttft: float | None = None
        try:
            async for ev in self._run_rounds(request_id, session_id, msgs,
                                             params, context, agg_stats,
                                             started, ttft):
                yield ev
        finally:
            self._active_sub.pop(request_id, None)

    async def _run_rounds(self, request_id: str, session_id: str,
                          msgs: list[dict], params: GenerationParams,
                          context: dict, agg_stats: dict, started: float,
                          ttft: float | None,
                          ) -> AsyncGenerator[dict, None]:
        for round_no in range(self.max_tool_rounds + 1):
            parser = HermesStreamParser()
            raw_text = ""
            calls_this_round = []
            terminal = None
            sub_id = f"{request_id}.t{round_no}"
            self._active_sub[request_id] = sub_id
            agen = self.engine.generate(sub_id, session_id, msgs, params)
            async for event in agen:
                etype = event["type"]
                if etype == "token":
                    raw_text += event["text"]
                    # Split around the first completed call: collect THIS
                    # feed's calls before judging its text (a chunk can
                    # both complete a <tool_call> and carry prose,
                    # ADVICE r3), and stream the prose that PRECEDED the
                    # round's first call even when it arrives in the same
                    # chunk that completes it — chunk boundaries are
                    # arbitrary (ADVICE r4). All completed calls execute
                    # (the reference accumulated every streamed call
                    # before executing, vllm_handler.py:389-412).
                    pre, calls, post = parser.feed_split(event["text"])
                    had_calls = bool(calls_this_round)
                    calls_this_round.extend(calls)
                    if not had_calls and pre:
                        if ttft is None:
                            ttft = (time.monotonic() - started) * 1000
                        yield {"type": "token", "text": pre}
                    if calls_this_round:
                        # Once a tool block exists, no FURTHER text is
                        # forwarded to the client: the round is aborted
                        # and regenerated with the tool results, so
                        # trailing prose would show up as a stray
                        # duplicated fragment. Prose in a LATER chunk
                        # (one that completed no call itself) means the
                        # model moved on past the block — stop the
                        # round and execute what we have.
                        if had_calls and not calls and pre.strip():
                            break
                        continue
                elif etype in ("done", "cancelled", "error"):
                    terminal = event
                    st = event.get("stats", {})
                    # `or 0`: remote backends report None when the
                    # upstream gave no usage accounting.
                    agg_stats["tokens_generated"] += st.get(
                        "tokens_generated") or 0
                    agg_stats["prompt_tokens"] = (
                        st.get("prompt_tokens")
                        or agg_stats["prompt_tokens"])

            if terminal is None:
                # Broke out on a tool call mid-stream: close the stream,
                # which cancels the engine request and frees its slot.
                await agen.aclose()
            else:
                tail = parser.flush()
                if tail and not calls_this_round:
                    # With calls pending the round is aborted and
                    # regenerated — a flushed fragment (e.g. a lone "<"
                    # that looked like a tag opener) must not leak to
                    # the client, same policy as the in-stream
                    # suppression above.
                    yield {"type": "token", "text": tail}
                if terminal["type"] in ("cancelled", "error"):
                    yield self._final(terminal, agg_stats, started, ttft)
                    return
                if not calls_this_round:
                    yield self._final(terminal, agg_stats, started, ttft)
                    return

            if round_no >= self.max_tool_rounds:
                log.warning(f"[{session_id}] tool-round limit reached")
                yield self._final(
                    {"type": "done", "finish_reason": "tool_rounds"},
                    agg_stats, started, ttft)
                return

            # Execute EVERY completed call of the round, concurrently
            # (tools are independent: read-only lookups or idempotent
            # fetches; the registry serialises rate-limited ones
            # itself), then append all results before resuming —
            # matching the reference's accumulate-then-execute-all
            # (vllm_handler.py:389-412).
            for call in calls_this_round:
                self._m_calls.inc()
                yield {"type": "tool_call", "tool": call.name,
                       "arguments": call.arguments}
            results = await asyncio.gather(
                *(self.registry.execute(c.name, c.arguments,
                                        context=context)
                  for c in calls_this_round))
            msgs = msgs + [{"role": "assistant", "content": raw_text}]
            for call, result in zip(calls_this_round, results):
                log.info(f"[{session_id}] tool {call.name} -> "
                         f"{result[:120]}")
                msgs = msgs + [
                    {"role": "tool",
                     "content": format_tool_result(call.name, result)},
                ]

        yield self._final({"type": "done", "finish_reason": "tool_rounds"},
                          agg_stats, started, ttft)

    def _final(self, terminal: dict, agg: dict, started: float,
               ttft: float | None) -> dict:
        dur = time.monotonic() - started
        toks = agg["tokens_generated"]
        out = {
            "type": terminal["type"],
            "finish_reason": terminal.get("finish_reason", "stop"),
            "stats": {
                "tokens_generated": toks,
                "processing_time_ms": dur * 1000,
                "tokens_per_second": toks / dur if dur > 0 else 0.0,
                "ttft_ms": ttft,
                "prompt_tokens": agg.get("prompt_tokens", 0),
            },
        }
        # Error events must keep their payload: the serving layer keys
        # load-shed handling (deadline_expired → retry_after frame /
        # 429, breaker untouched) on `code`, and stripping it here made
        # every agent-path expiry count as a backend failure.
        for key in ("error", "code", "retry_after"):
            if key in terminal:
                out[key] = terminal[key]
        return out

    async def aclose(self) -> None:
        """Release tool resources (search backend HTTP session)."""
        await self.registry.aclose()

    # Engine-seam passthroughs so the agent is substitutable wherever an
    # EngineBase is expected (WS server, OpenAI route).
    def check_connection(self) -> bool:
        return self.engine.check_connection()

    def cancel(self, request_id: str) -> bool:
        sub = self._active_sub.get(request_id)
        return self.engine.cancel(sub or request_id)

    def release_session(self, session_id: str) -> None:
        self.engine.release_session(session_id)

    def get_stats(self) -> dict:
        return self.engine.get_stats()

    def get_model_info(self) -> dict:
        info = dict(self.engine.get_model_info())
        info["tools"] = self.registry.names()
        return info
