"""Live web-search backends for the agent's `web_search` tool.

The reference shipped live DuckDuckGo search via the duckduckgo-search
package (voice_agent.py:147-152, duckduckgo_search_tool()). This is the
in-tree equivalent: an aiohttp client against DuckDuckGo's HTML endpoint
(no API key, same data source the package scrapes), parsed defensively
with the stdlib HTMLParser — no extra dependency, and a zero-egress
deployment degrades to OfflineSearchBackend automatically instead of
failing the agent.

Backend selection (WEB_SEARCH_BACKEND):
  auto       — DuckDuckGo with automatic offline fallback (default)
  duckduckgo — DuckDuckGo, errors surface to the model as tool errors
  offline    — always the graceful offline explanation

The port's copy of ``fasttalk_tpu/agents/search.py`` (imports only).
"""

from __future__ import annotations

import asyncio
import time
import urllib.parse
from html.parser import HTMLParser
from typing import Any

from fasttalk_tpu_torch.agents.tools import OfflineSearchBackend, WebSearchBackend
from fasttalk_tpu_torch.utils.logger import get_logger

log = get_logger("agents.search")

DDG_HTML_URL = "https://html.duckduckgo.com/html/"


_VOID_TAGS = frozenset({"br", "img", "hr", "input", "meta", "link", "area",
                        "base", "col", "embed", "source", "track", "wbr"})


class _DDGResultParser(HTMLParser):
    """Pulls (title, url, snippet) triples out of DuckDuckGo's HTML
    results page. The page structure: each result has an
    <a class="result__a" href=...> title anchor and an
    <a|div class="result__snippet"> body. Parsed as a tolerant state
    machine — unknown markup is ignored rather than fatal."""

    def __init__(self) -> None:
        super().__init__(convert_charrefs=True)
        self.results: list[dict[str, str]] = []
        self._current: dict[str, str] | None = None
        self._capture: str | None = None  # "title" | "snippet"
        self._depth = 0

    def handle_starttag(self, tag: str, attrs: list) -> None:
        # Void elements (<br>, <img>, ...) never get a close tag, so they
        # must not count toward capture depth; <br> reads as whitespace.
        if tag in _VOID_TAGS:
            if tag == "br" and self._capture and self._current is not None:
                self._current[self._capture] += " "
            return
        a = dict(attrs)
        classes = (a.get("class") or "").split()
        if tag == "a" and "result__a" in classes:
            if self._current:
                self.results.append(self._current)
            self._current = {"title": "", "url": _clean_url(a.get("href", "")),
                             "snippet": ""}
            self._capture, self._depth = "title", 1
        elif "result__snippet" in classes and self._current is not None:
            self._capture, self._depth = "snippet", 1
        elif self._capture:
            self._depth += 1

    def handle_endtag(self, tag: str) -> None:
        if self._capture and tag not in _VOID_TAGS:
            self._depth -= 1
            if self._depth <= 0:
                self._capture = None

    def handle_data(self, data: str) -> None:
        if self._capture and self._current is not None:
            self._current[self._capture] += data

    def close(self) -> None:
        super().close()
        if self._current:
            self.results.append(self._current)
            self._current = None


def _clean_url(href: str) -> str:
    """DuckDuckGo wraps result links in a redirect:
    //duckduckgo.com/l/?uddg=<urlencoded-target>&rut=... — unwrap it."""
    if "duckduckgo.com/l/" in href:
        qs = urllib.parse.parse_qs(urllib.parse.urlsplit(href).query)
        target = qs.get("uddg", [""])[0]
        if target:
            return target
    if href.startswith("//"):
        return "https:" + href
    return href


def parse_ddg_html(html: str, max_results: int = 5) -> list[dict[str, str]]:
    parser = _DDGResultParser()
    try:
        parser.feed(html)
        parser.close()
    except Exception as e:  # malformed page: keep whatever parsed
        log.warning(f"ddg html parse stopped early: {e}")
    out = []
    for r in parser.results[:max_results]:
        out.append({"title": r["title"].strip(),
                    "url": r["url"],
                    "snippet": " ".join(r["snippet"].split())})
    return out


class DuckDuckGoSearchBackend(WebSearchBackend):
    """Live search against DuckDuckGo's HTML endpoint via aiohttp (the
    reference's data source, without the duckduckgo-search dependency)."""

    def __init__(self, url: str = DDG_HTML_URL, timeout_s: float = 10.0,
                 session_factory: Any = None):
        self.url = url
        self.timeout_s = timeout_s
        # injectable for tests (a mocked aiohttp.ClientSession)
        self._session_factory = session_factory
        self._session: Any = None
        self._loop: Any = None

    def _ensure_session(self):
        """Shared keep-alive session: per-query session setup would pay a
        fresh TCP+TLS handshake on every search in a latency-focused
        pipeline. Re-created if the running loop changed (tests run each
        case under its own asyncio.run loop)."""
        import aiohttp

        loop = asyncio.get_running_loop()
        if (self._session is None or self._session.closed
                or self._loop is not loop):
            old, old_loop = self._session, self._loop
            if old is not None and not old.closed:
                # Close the superseded session instead of abandoning it
                # (FD leak + "Unclosed client session" warnings,
                # ADVICE r2). A session must be closed on its OWN loop;
                # when that loop is gone, detach the connector and close
                # it synchronously — never awaited cross-loop, and any
                # close error is swallowed rather than surfacing as an
                # unhandled-task exception (ADVICE r3).
                async def _close_quietly(s=old):
                    try:
                        await s.close()
                    except Exception:
                        pass

                try:
                    if old_loop is loop:
                        loop.create_task(_close_quietly())
                    elif old_loop is not None and old_loop.is_running():
                        old_loop.call_soon_threadsafe(
                            lambda: asyncio.ensure_future(_close_quietly()))
                    else:
                        connector = getattr(old, "_connector", None)
                        old.detach()
                        if connector is not None:
                            connector.close()  # sync FD teardown
                except Exception:
                    pass
            self._session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=self.timeout_s),
                headers={"User-Agent": "Mozilla/5.0 (fasttalk-tpu agent)"})
            self._loop = loop
        return self._session

    async def aclose(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()
        self._session = None

    async def _fetch(self, session: Any, query: str) -> str:
        async with session.post(self.url, data={"q": query}) as resp:
            if resp.status != 200:
                raise RuntimeError(f"search HTTP {resp.status}")
            return await resp.text()

    async def search(self, query: str, max_results: int = 5) -> list[dict]:
        if self._session_factory is not None:
            async with self._session_factory() as session:
                html = await self._fetch(session, query)
        else:
            html = await self._fetch(self._ensure_session(), query)
        results = parse_ddg_html(html, max_results=max_results)
        if not results:
            return [{"title": "No results",
                     "snippet": f"No results found for {query!r}.",
                     "url": ""}]
        return results


class ResilientSearchBackend(WebSearchBackend):
    """Primary backend with automatic fallback. After a failure the
    primary is benched for `cooldown_s` so a dead egress path costs one
    timeout, not one per query."""

    def __init__(self, primary: WebSearchBackend,
                 fallback: WebSearchBackend | None = None,
                 cooldown_s: float = 300.0):
        self.primary = primary
        self.fallback = fallback or OfflineSearchBackend()
        self.cooldown_s = cooldown_s
        self._benched_until = 0.0

    async def search(self, query: str, max_results: int = 5) -> list[dict]:
        if time.monotonic() >= self._benched_until:
            try:
                return await self.primary.search(query,
                                                 max_results=max_results)
            except (Exception, asyncio.CancelledError) as e:
                if isinstance(e, asyncio.CancelledError):
                    raise
                self._benched_until = time.monotonic() + self.cooldown_s
                log.warning(
                    f"primary search failed ({e}); falling back for "
                    f"{self.cooldown_s:.0f}s")
        return await self.fallback.search(query, max_results=max_results)

    async def aclose(self) -> None:
        for be in (self.primary, self.fallback):
            close = getattr(be, "aclose", None)
            if close is not None:
                await close()


def backend_from_config(config: Any) -> WebSearchBackend:
    """Map WEB_SEARCH_BACKEND to a backend instance (see module doc)."""
    kind = str(getattr(config, "web_search_backend", "auto")).lower()
    timeout = float(getattr(config, "web_search_timeout", 10.0))
    if kind == "offline":
        return OfflineSearchBackend()
    ddg = DuckDuckGoSearchBackend(timeout_s=timeout)
    if kind == "duckduckgo":
        return ddg
    return ResilientSearchBackend(ddg)
