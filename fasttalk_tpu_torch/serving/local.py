"""Local in-process server bootstrap for scripts and tests: build the
engine, warm it up, start it, and serve the WebSocket protocol on
127.0.0.1 (the port's copy of ``fasttalk_tpu/serving/local.py``)."""

from __future__ import annotations

from typing import Any

import torch

from fasttalk_tpu_torch.utils.config import Config


async def start_local_server(cfg: Config, *, warmup: str | None = None,
                             with_agent: bool = True,
                             device: str | torch.device | None = None,
                             ) -> tuple[Any, Any]:
    """Returns (engine, runner); the caller owns cleanup:
    ``await runner.cleanup(); engine.shutdown()``."""
    from aiohttp import web

    from fasttalk_tpu_torch.engine.factory import build_engine
    from fasttalk_tpu_torch.serving.launcher import build_agent
    from fasttalk_tpu_torch.serving.server import WebSocketLLMServer

    engine = build_engine(cfg, device=device)
    engine.warmup(warmup if warmup is not None else (cfg.warmup or "fast"))
    engine.start()
    agent = build_agent(cfg, engine) if with_agent else None
    server = WebSocketLLMServer(cfg, engine, agent)
    runner = web.AppRunner(server.app)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", cfg.port).start()
    return engine, runner
