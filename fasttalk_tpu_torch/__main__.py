"""Command line: ``python -m fasttalk_tpu_torch websocket [--device cuda|cpu]``.

Builds the engine from the environment (utils/config.py: LLM_MODEL,
MODEL_PATH, TPU_DECODE_SLOTS, TPU_MAX_MODEL_LEN, WEIGHT_QUANT, LLM_PORT,
...) and serves the WebSocket protocol on ``/ws/llm`` until interrupted.
"""

from __future__ import annotations

import argparse
import asyncio
import signal


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m fasttalk_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    ws = sub.add_parser("websocket", help="serve the WebSocket protocol")
    ws.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)

    from fasttalk_tpu_torch.engine.factory import build_engine
    from fasttalk_tpu_torch.serving.server import serve
    from fasttalk_tpu_torch.utils.config import Config

    config = Config()
    engine = build_engine(config, device=args.device)
    engine.start()

    async def run() -> None:
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await serve(config, engine, stop)

    try:
        asyncio.run(run())
    finally:
        engine.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
