"""Per-session conversation state with token-budget history trimming.

Capability parity with the reference conversation manager
(app/core/conversation_manager.py:19-285), with two deliberate upgrades
called out in SURVEY.md §5: trimming is by *token budget* measured with
the real tokenizer (the reference trimmed by message count,
conversation_manager.py:40-52), and idle-session GC is actually scheduled
(the reference defined cleanup_idle_sessions but never called it).

Single-threaded by design: only the serving event loop touches this.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

from fasttalk_tpu_torch.utils.logger import get_logger

log = get_logger("serving.conversation")


@dataclass
class ConversationState:
    session_id: str
    system_prompt: str | None = None
    messages: list[dict[str, str]] = field(default_factory=list)
    created_at: float = field(default_factory=time.time)
    last_activity: float = field(default_factory=time.time)
    total_tokens_generated: int = 0
    turns: int = 0
    # Per-session generation overrides (reference flaw: these were
    # silently dropped — SURVEY.md known-flaws list).
    gen_config: dict[str, Any] = field(default_factory=dict)


class ConversationManager:
    def __init__(self, count_tokens: Callable[[str], int] | None = None,
                 max_history_tokens: int = 6144,
                 session_timeout: float = 3600.0,
                 default_system_prompt: str | None = None):
        # Fallback heuristic ≈ 4 chars/token when no tokenizer is wired.
        self._count = count_tokens or (lambda s: max(1, len(s) // 4))
        self.max_history_tokens = max_history_tokens
        self.session_timeout = session_timeout
        self.default_system_prompt = default_system_prompt
        self._sessions: dict[str, ConversationState] = {}

    def create_session(self, session_id: str,
                       system_prompt: str | None = None,
                       gen_config: dict[str, Any] | None = None,
                       ) -> ConversationState:
        state = ConversationState(
            session_id=session_id,
            system_prompt=system_prompt if system_prompt is not None
            else self.default_system_prompt,
            gen_config=dict(gen_config or {}))
        self._sessions[session_id] = state
        return state

    def get(self, session_id: str) -> ConversationState | None:
        return self._sessions.get(session_id)

    def get_or_create(self, session_id: str) -> ConversationState:
        state = self._sessions.get(session_id)
        if state is None:
            state = self.create_session(session_id)
        return state

    def update_config(self, session_id: str,
                      overrides: dict[str, Any]) -> None:
        state = self.get_or_create(session_id)
        overrides = dict(overrides)
        if "system_prompt" in overrides:
            state.system_prompt = overrides.pop("system_prompt")
        state.gen_config.update(overrides)
        state.last_activity = time.time()

    def add_user_message(self, session_id: str, text: str) -> None:
        state = self.get_or_create(session_id)
        state.messages.append({"role": "user", "content": text})
        state.last_activity = time.time()

    def add_assistant_message(self, session_id: str, text: str,
                              tokens_generated: int = 0) -> None:
        state = self.get_or_create(session_id)
        state.messages.append({"role": "assistant", "content": text})
        state.total_tokens_generated += tokens_generated
        state.turns += 1
        state.last_activity = time.time()

    def add_tool_message(self, session_id: str, text: str) -> None:
        state = self.get_or_create(session_id)
        state.messages.append({"role": "tool", "content": text})
        state.last_activity = time.time()

    def get_messages_for_generation(self, session_id: str,
                                    ) -> list[dict[str, str]]:
        """History for the model: system prompt + newest messages that fit
        the token budget. The system prompt always survives trimming."""
        state = self.get_or_create(session_id)
        out: list[dict[str, str]] = []
        budget = self.max_history_tokens
        if state.system_prompt:
            budget -= self._count(state.system_prompt)
        kept: list[dict[str, str]] = []
        for msg in reversed(state.messages):
            cost = self._count(msg["content"]) + 8  # + role/format overhead
            if cost > budget and kept:
                break
            if cost > budget:
                # A single over-budget message: keep it anyway (the engine
                # enforces the hard context cap) rather than sending
                # an empty history.
                kept.append(msg)
                break
            kept.append(msg)
            budget -= cost
        if state.system_prompt:
            out.append({"role": "system", "content": state.system_prompt})
        out.extend(reversed(kept))
        return out

    def end_session(self, session_id: str) -> None:
        self._sessions.pop(session_id, None)

    def cleanup_idle_sessions(self, now: float | None = None) -> int:
        """Drop sessions idle past the timeout. Called from the serving
        loop's periodic housekeeping task (actually scheduled, unlike the
        reference)."""
        now = now or time.time()
        idle = [sid for sid, s in self._sessions.items()
                if now - s.last_activity > self.session_timeout]
        for sid in idle:
            del self._sessions[sid]
        if idle:
            log.info(f"cleaned up {len(idle)} idle sessions")
        return len(idle)

    def get_session_count(self) -> int:
        return len(self._sessions)

    def get_statistics(self) -> dict[str, Any]:
        return {
            "active_sessions": len(self._sessions),
            "total_messages": sum(len(s.messages)
                                  for s in self._sessions.values()),
            "total_tokens_generated": sum(s.total_tokens_generated
                                          for s in self._sessions.values()),
            "total_turns": sum(s.turns for s in self._sessions.values()),
        }
