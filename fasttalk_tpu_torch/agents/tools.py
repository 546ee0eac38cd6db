"""Tool registry and built-in tools.

Parity with the reference agent's tool surface (voice_agent.py:147-188:
DuckDuckGo web search, get_current_time, get_session_info), rebuilt as a
provider-agnostic registry the native agent loop executes itself. Web
search is pluggable: the default backend degrades gracefully in
zero-egress deployments instead of failing the whole agent, and a
rate limiter guards whatever backend is wired
(reference: duckduckgo_rate_limit, config.py:106).

The port's copy of ``fasttalk_tpu/agents/tools.py`` (imports only).
"""

from __future__ import annotations

import asyncio
import inspect
import json
import time
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, Awaitable, Callable

from fasttalk_tpu_torch.utils.logger import get_logger

log = get_logger("agents.tools")

ToolFn = Callable[..., Any | Awaitable[Any]]


@dataclass
class Tool:
    name: str
    description: str
    parameters: dict[str, Any]  # JSON-schema properties
    fn: ToolFn
    required: list[str] = field(default_factory=list)

    def spec(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "description": self.description,
            "parameters": {
                "type": "object",
                "properties": self.parameters,
                "required": self.required,
            },
        }


class ToolRegistry:
    def __init__(self) -> None:
        self._tools: dict[str, Tool] = {}
        # Resources (e.g. the search backend's HTTP session) that must
        # be released on shutdown — long-lived processes leak FDs
        # otherwise (ADVICE r2).
        self._closeables: list[Any] = []

    def register(self, tool: Tool) -> None:
        self._tools[tool.name] = tool

    def add_closeable(self, obj: Any) -> None:
        self._closeables.append(obj)

    async def aclose(self) -> None:
        for obj in self._closeables:
            close = getattr(obj, "aclose", None)
            if close is None:
                continue
            try:
                await close()
            except Exception as e:  # shutdown must not raise
                log.warning(f"closing {type(obj).__name__} failed: {e}")

    def get(self, name: str) -> Tool | None:
        return self._tools.get(name)

    def specs(self) -> list[dict[str, Any]]:
        return [t.spec() for t in self._tools.values()]

    def names(self) -> list[str]:
        return list(self._tools)

    async def execute(self, name: str, arguments: dict[str, Any],
                      context: dict[str, Any] | None = None,
                      timeout: float = 20.0) -> str:
        """Run a tool; always returns a string result (errors included, so
        the model can recover)."""
        tool = self._tools.get(name)
        if tool is None:
            return json.dumps({"error": f"unknown tool {name!r}",
                               "available": self.names()})
        try:
            kwargs = dict(arguments)
            sig = inspect.signature(tool.fn)
            if "context" in sig.parameters:
                kwargs["context"] = context or {}
            kwargs = {k: v for k, v in kwargs.items()
                      if k in sig.parameters}
            result = tool.fn(**kwargs)
            if inspect.isawaitable(result):
                result = await asyncio.wait_for(result, timeout=timeout)
            return result if isinstance(result, str) else json.dumps(result)
        except asyncio.TimeoutError:
            return json.dumps({"error": f"tool {name} timed out"})
        except Exception as e:
            log.error(f"tool {name} failed: {e}")
            return json.dumps({"error": f"tool {name} failed: {e}"})


class RateLimiter:
    """Minimum spacing between calls (reference: DUCKDUCKGO_RATE_LIMIT)."""

    def __init__(self, min_interval_s: float = 1.0):
        self.min_interval_s = min_interval_s
        self._last = 0.0
        self._lock = asyncio.Lock()

    async def wait(self) -> None:
        async with self._lock:
            now = time.monotonic()
            delta = self.min_interval_s - (now - self._last)
            if delta > 0:
                await asyncio.sleep(delta)
            self._last = time.monotonic()


# ---------------- built-in tools ----------------

def get_current_time() -> str:
    now = datetime.now(timezone.utc)
    return json.dumps({
        "utc": now.strftime("%Y-%m-%d %H:%M:%S UTC"),
        "iso": now.isoformat(),
        "unix": int(now.timestamp()),
    })


def get_session_info(context: dict[str, Any] | None = None) -> str:
    ctx = context or {}
    return json.dumps({
        "session_id": ctx.get("session_id", "unknown"),
        "turns": ctx.get("turns", 0),
        "model": ctx.get("model", "unknown"),
        "started_at": ctx.get("started_at"),
    })


class WebSearchBackend:
    """Pluggable search. Subclass and register to wire a real provider."""

    async def search(self, query: str, max_results: int = 5) -> list[dict]:
        raise NotImplementedError


class OfflineSearchBackend(WebSearchBackend):
    """Zero-egress default: fails soft with a structured explanation so
    the model can tell the user instead of the agent crashing."""

    async def search(self, query: str, max_results: int = 5) -> list[dict]:
        return [{
            "title": "Web search unavailable",
            "snippet": ("This deployment has no internet egress; live web "
                        "search is disabled. Answer from model knowledge "
                        "and say so."),
            "url": "",
        }]


def build_default_registry(
        enable_web_search: bool = True,
        search_backend: WebSearchBackend | None = None,
        search_rate_limit_s: float = 1.0) -> ToolRegistry:
    reg = ToolRegistry()
    reg.register(Tool(
        name="get_current_time",
        description="Get the current date and time (UTC).",
        parameters={}, fn=get_current_time))
    reg.register(Tool(
        name="get_session_info",
        description="Get information about the current conversation "
                    "session.",
        parameters={}, fn=get_session_info))
    if enable_web_search:
        backend = search_backend or OfflineSearchBackend()
        reg.add_closeable(backend)
        limiter = RateLimiter(search_rate_limit_s)

        async def web_search(query: str, max_results: int = 5) -> str:
            await limiter.wait()
            results = await backend.search(query,
                                           max_results=int(max_results))
            return json.dumps({"query": query, "results": results})

        reg.register(Tool(
            name="web_search",
            description="Search the web for current information.",
            parameters={
                "query": {"type": "string",
                          "description": "search query"},
                "max_results": {"type": "integer", "default": 5},
            },
            required=["query"], fn=web_search))
    return reg
