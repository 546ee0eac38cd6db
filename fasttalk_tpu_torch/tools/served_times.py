#!/usr/bin/env python3
"""Serve the port's main path on one CUDA GPU, for one checkout or several
in turns, and report what the WebSocket clients saw.

    python3 fasttalk_tpu_torch/tools/served_times.py [--root DIR |
        --roots DIR,DIR,...] [--sessions 16] [--max-tokens 64] [--out PATH]

Serves through this checkout's ``chip_smoke.serve_main_path`` (llama3.2:1b
at full width, int8 random weights, 16 slots, max_len 2048, prefill chunk
512, dense bf16 KV, the package's own defaults for everything else; one
warm-up session) with the ``fasttalk_tpu_torch`` package imported from
``--root`` (default: the checkout holding this file), drives ``--sessions``
concurrent sessions of ``--max-tokens`` tokens at temperature 0.7 with
``chip_smoke.drive_sessions``, and reports decode tok/s over the sessions'
wall time, TTFT p50/p99 from the ``done`` frames, error frames, and the
engine's decode calls, steps and host enqueue time over the window.
``--roots`` runs one process per entry in the order given (parent,
change, change, parent compares two checkouts on one card). Prints one
JSON object as its last line, and writes it to ``--out`` as well.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _load(name: str, path: str):
    """A module of this checkout by file path, so that the package is
    imported from ``--root`` and nowhere else."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def serve_once(root: str, sessions: int, max_tokens: int) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import fasttalk_tpu_torch
    from fasttalk_tpu_torch.ops import _build

    smoke = _load("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    _build.build()

    async def drive(engine, port: int) -> dict:
        keys = ("decode_calls", "decode_steps", "decode_host_s")
        before = engine.get_stats()
        out = await smoke.drive_sessions(port, sessions, max_tokens)
        after = engine.get_stats()
        out.update({k: after[k] - before[k] for k in keys})
        return out

    out = smoke.serve_main_path(drive)
    out["package"] = os.path.dirname(fasttalk_tpu_torch.__file__)
    out["decode_tok_s"] = out["tokens"] / out["wall_s"]
    out["ttft_p50_ms"] = smoke.pct(out["ttft_ms"], 50)
    out["ttft_p99_ms"] = smoke.pct(out["ttft_ms"], 99)
    out["errors"] = len(out["errors"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO,
                    help="checkout whose fasttalk_tpu_torch is served")
    ap.add_argument("--roots", default="",
                    help="checkouts to serve in turns, one process each")
    ap.add_argument("--sessions", type=int, default=16)
    ap.add_argument("--max-tokens", type=int, default=64)
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args()
    import torch

    card_name = _load("kernel_times", os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "kernel_times.py")).card_name
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if args.roots:
        turns = []
        for root in args.roots.split(","):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--root", root,
                 "--sessions", str(args.sessions), "--max-tokens",
                 str(args.max_tokens)], capture_output=True, text=True)
            sys.stderr.write(proc.stderr[-4000:])
            if proc.returncode != 0:
                print(proc.stdout[-4000:], file=sys.stderr)
                return proc.returncode
            turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        out = {"card": card_name(), "turns": turns}
    else:
        out = {"card": card_name(),
               **serve_once(args.root, args.sessions, args.max_tokens)}
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
