"""FakeEngine: an in-memory EngineBase for fast protocol-level tests.

Fills the role SURVEY.md §4 prescribes — a fake backend behind the engine
seam so WebSocket-protocol integration tests run in milliseconds with no
device. Deterministic: echoes a canned completion token by token.

The port's copy of ``fasttalk_tpu/engine/fake.py`` (imports only).
"""

from __future__ import annotations

import asyncio
from typing import AsyncGenerator

from fasttalk_tpu_torch.engine.engine import EngineBase, GenerationParams


class FakeEngine(EngineBase):
    def __init__(self, reply: str = "Hello from the fake engine. ",
                 n_repeats: int = 4, delay_s: float = 0.0):
        self.reply = reply
        self.n_repeats = n_repeats
        self.delay_s = delay_s
        self._cancelled: set[str] = set()
        self._active: set[str] = set()
        self.released_sessions: list[str] = []
        self.requests_seen: list[dict] = []
        self._started = False

    def start(self) -> None:
        self._started = True

    def shutdown(self) -> None:
        self._started = False

    async def generate(self, request_id: str, session_id: str,
                       messages: list[dict], params: GenerationParams,
                       ) -> AsyncGenerator[dict, None]:
        self.requests_seen.append({
            "request_id": request_id, "session_id": session_id,
            "messages": messages, "params": params,
        })
        self._active.add(request_id)
        import time
        start = time.monotonic()
        words = (self.reply * self.n_repeats).split(" ")
        count = 0
        reason = "stop"
        try:
            for i, w in enumerate(words):
                if request_id in self._cancelled:
                    yield {"type": "cancelled", "finish_reason": "cancelled",
                           "stats": self._stats(count, start)}
                    return
                if count >= params.max_tokens:
                    reason = "length"
                    break
                await asyncio.sleep(self.delay_s)
                count += 1
                yield {"type": "token",
                       "text": w + (" " if i < len(words) - 1 else "")}
            yield {"type": "done", "finish_reason": reason,
                   "stats": self._stats(count, start)}
        finally:
            self._active.discard(request_id)
            self._cancelled.discard(request_id)

    def _stats(self, tokens: int, start: float) -> dict:
        import time
        dur = time.monotonic() - start
        return {
            "tokens_generated": tokens,
            "processing_time_ms": dur * 1000,
            "tokens_per_second": tokens / dur if dur > 0 else 0.0,
            "ttft_ms": 1.0,
            "prompt_tokens": 5,
        }

    def cancel(self, request_id: str) -> bool:
        if request_id in self._active:
            self._cancelled.add(request_id)
            return True
        return False

    def release_session(self, session_id: str) -> None:
        self.released_sessions.append(session_id)

    def check_connection(self) -> bool:
        return self._started

    def get_model_info(self) -> dict:
        return {"model": "fake", "parameters": 0, "context_window": 8192,
                "decode_slots": 16, "dtype": "none", "devices": []}

    def get_stats(self) -> dict:
        return {"slots": {"total_slots": 16, "active": len(self._active),
                          "pinned": 0, "resident_tokens": 0},
                "waiting": 0, "running": len(self._active)}
