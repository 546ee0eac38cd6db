"""WebSocket connection registry: admission, state machine, per-session
and global counters.

A copy of ``fasttalk_tpu/serving/connection.py`` (the port
imports nothing of the JAX package); the two must behave the same on
the same inputs.

Capability parity with the reference connection manager
(app/utils/connection_manager.py:18-366) rebuilt asyncio-native: the
reference used a threading.Lock everywhere (and still managed a
self-deadlock in get_detailed_stats, SURVEY.md §5); here every access
happens on the serving event loop, so the design needs no locks at all.
Token counters live in the process-wide metrics registry — one source of
truth instead of the reference's double counting.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any

from fasttalk_tpu_torch.utils.metrics import get_metrics


class ConnectionState(str, Enum):
    CONNECTING = "connecting"
    ACTIVE = "active"
    PROCESSING = "processing"
    IDLE = "idle"
    DISCONNECTING = "disconnecting"


@dataclass
class ConnectionInfo:
    session_id: str
    websocket: Any
    state: ConnectionState = ConnectionState.CONNECTING
    connected_at: float = field(default_factory=time.time)
    last_activity: float = field(default_factory=time.time)
    messages_received: int = 0
    messages_sent: int = 0
    tokens_generated: int = 0
    generations: int = 0
    errors: int = 0
    config: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {
            "session_id": self.session_id,
            "state": self.state.value,
            "connected_at": self.connected_at,
            "duration_seconds": time.time() - self.connected_at,
            "messages_received": self.messages_received,
            "messages_sent": self.messages_sent,
            "tokens_generated": self.tokens_generated,
            "generations": self.generations,
            "errors": self.errors,
        }


class ConnectionManager:
    def __init__(self, max_connections: int = 50,
                 idle_timeout: float = 3600.0):
        self.max_connections = max_connections
        self.idle_timeout = idle_timeout
        self._connections: dict[str, ConnectionInfo] = {}
        m = get_metrics()
        self._m_total = m.counter("ws_connections_total",
                                  "WebSocket connections accepted")
        self._m_rejected = m.counter("ws_connections_rejected_total",
                                     "connections rejected at admission")
        self._m_active = m.gauge("ws_connections_active",
                                 "currently connected sessions")
        # Process-lifetime frame counters: the per-connection fields
        # above die with the connection, so aggregate receive/send rates
        # were invisible to a scraper.
        self._m_recv = m.counter("ws_messages_received_total",
                                 "WS messages received, all sessions")
        self._m_sent = m.counter("ws_messages_sent_total",
                                 "WS frames sent, all sessions")

    def add_connection(self, session_id: str, websocket: Any,
                       ) -> ConnectionInfo | None:
        """Admit a connection; None if at capacity."""
        if len(self._connections) >= self.max_connections:
            self._m_rejected.inc()
            return None
        info = ConnectionInfo(session_id=session_id, websocket=websocket,
                              state=ConnectionState.ACTIVE)
        self._connections[session_id] = info
        self._m_total.inc()
        self._m_active.set(len(self._connections))
        return info

    def remove_connection(self, session_id: str) -> None:
        self._connections.pop(session_id, None)
        self._m_active.set(len(self._connections))

    def get_connection(self, session_id: str) -> ConnectionInfo | None:
        return self._connections.get(session_id)

    def update_connection_state(self, session_id: str,
                                state: ConnectionState) -> None:
        info = self._connections.get(session_id)
        if info:
            info.state = state
            info.last_activity = time.time()

    def record_message_received(self, session_id: str) -> None:
        self._m_recv.inc()
        info = self._connections.get(session_id)
        if info:
            info.messages_received += 1
            info.last_activity = time.time()

    def record_message_sent(self, session_id: str) -> None:
        self._m_sent.inc()
        info = self._connections.get(session_id)
        if info:
            info.messages_sent += 1

    def record_tokens_generated(self, session_id: str, n: int = 1) -> None:
        info = self._connections.get(session_id)
        if info:
            info.tokens_generated += n

    def record_generation_complete(self, session_id: str) -> None:
        info = self._connections.get(session_id)
        if info:
            info.generations += 1
            info.last_activity = time.time()

    def record_error(self, session_id: str) -> None:
        info = self._connections.get(session_id)
        if info:
            info.errors += 1

    def get_active_count(self) -> int:
        return len(self._connections)

    def retry_after_hint(self) -> float:
        """Suggested reconnect back-off (seconds) when admission is
        refused at the connection limit: short when most sessions are
        idle (likely to churn soon), longer when every connection is
        mid-generation."""
        conns = list(self._connections.values())
        if not conns:
            return 1.0
        busy = sum(1 for c in conns
                   if c.state is ConnectionState.PROCESSING)
        return round(2.0 + 8.0 * busy / len(conns), 1)

    def idle_sessions(self, now: float | None = None) -> list[str]:
        now = now or time.time()
        return [sid for sid, c in self._connections.items()
                if now - c.last_activity > self.idle_timeout
                and c.state is not ConnectionState.PROCESSING]

    def get_statistics(self) -> dict[str, Any]:
        conns = list(self._connections.values())
        return {
            "active_connections": len(conns),
            "max_connections": self.max_connections,
            "total_connections": self._m_total.value,
            "rejected_connections": self._m_rejected.value,
            "states": {s.value: sum(1 for c in conns if c.state is s)
                       for s in ConnectionState},
            "total_messages_received": sum(c.messages_received for c in conns),
            "total_messages_sent": sum(c.messages_sent for c in conns),
            "total_tokens_generated": sum(c.tokens_generated for c in conns),
        }

    def get_detailed_stats(self) -> dict[str, Any]:
        # Unlike the reference (connection_manager.py:341-355, which
        # self-deadlocked here), this is plain single-threaded code.
        return {
            **self.get_statistics(),
            "sessions": [c.to_dict() for c in self._connections.values()],
        }
