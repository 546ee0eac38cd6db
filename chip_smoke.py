#!/usr/bin/env python3
"""Drive fasttalk_tpu_torch's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each fatal on failure (the script then exits non-zero and prints
no result line):

1. the card's name and power limit (nvidia-smi); build every CUDA kernel
   of ``fasttalk_tpu_torch/csrc`` with nvcc, one process per source;
2. each kernel against its plain PyTorch version on the card at the
   shapes the Llama-3.2-1B decode step gives it, with the tolerance
   stated, then timed with CUDA events beside its plain version, one
   PyTorch library call computing the same function, and its bound;
3. llama3.2:1b at full width (int8 random weights on the card): prefill
   plus decode steps through the kernels against the same forward through
   the plain versions, by logits and greedy tokens;
4. the trained tinychat checkpoint (read in place from
   ``fasttalk_tpu/assets``) with int8 weights: the greedy answer to "what
   color is the sky?";
5. the WebSocket server in-process through ``build_engine`` (full-width
   llama3.2:1b, int8, 16 slots, max_len 2048, prefill chunk 512) with 16
   concurrent sessions. The kernels' launch counts are zeroed just before
   this phase and read just after; every kernel must have launched.

The line before the last is one JSON object listing the kernels; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import math
import os
import subprocess
import sys
import time
import traceback

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
L2_FLUSH_BYTES = 200 * 2**20   # rotate buffers past the 50 MB L2

REPO = os.path.dirname(os.path.abspath(__file__))
ASSETS = os.path.join(REPO, "fasttalk_tpu", "assets")

# Llama-3.2-1B decode shapes: (K, N) of the seven per-layer matmuls and
# how many of each a layer runs.
LAYER_MATMULS = {(2048, 2048): 2, (2048, 512): 2, (2048, 8192): 2,
                 (8192, 2048): 1}
LAYERS, SLOTS, VOCAB, HIDDEN = 16, 16, 128256, 2048
NQ, NKV, HEAD_DIM, MAX_LEN = 32, 8, 64, 2048


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` calls: the calls are
    captured into one CUDA graph and the replay is timed with CUDA events,
    so the host's launch cost (eager PyTorch and ctypes) does not enter the
    figure."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def copies_for(nbytes: int) -> int:
    return max(1, min(64, math.ceil(L2_FLUSH_BYTES / max(1, nbytes))))


# decode_attend is held slot by slot: each slot's largest |kernel - plain|
# against 1% of that slot's largest |plain| output. Kernel and plain both
# accumulate in f32 and round to bf16 once, and one bf16 step is at most
# 2^-7 (0.78%) of a value, so a right kernel stays under 1%. A slot over a
# long prefix averages hundreds of keys and its outputs are small, so a
# bound taken from the whole batch would let a missed or extra key pass.
ATTEND_SLOT_TOL = 1e-2


def attend_slot_gaps(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """[B]: max |got - ref| over slot b's outputs / max |ref| over them."""
    got, ref = got.float().flatten(1), ref.float().flatten(1)
    return (got - ref).abs().amax(1) / ref.abs().amax(1).clamp_min(1e-30)


# ---------------------------------------------------------------- phase 2

def check_int8_matmul(results: dict) -> None:
    from fasttalk_tpu_torch.ops.cuda_int8 import int8_matmul, int8_matmul_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
            "bytes": 0.0, "ops": 0.0}
    worst = 0.0
    for (k, n), per_layer in LAYER_MATMULS.items():
        for m in (SLOTS, 1):
            n_cp = copies_for(k * n)
            qs = [torch.randint(-127, 128, (k, n), generator=g, device=dev,
                                dtype=torch.int8) for _ in range(n_cp)]
            s = torch.rand((n,), generator=g, device=dev) * 0.02 + 1e-3
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            got = int8_matmul(x, qs[0], s).float()
            ref = int8_matmul_plain(x, qs[0], s).float()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            tol = 1e-2 * ref.abs().max().item()
            log(f"int8_matmul M={m} K={k} N={n}: max_abs_err={err:.6g} "
                f"(tol {tol:.6g})")
            if not err <= tol:
                fail(f"int8_matmul disagrees with its plain version at "
                     f"M={m} K={k} N={n}: {err} > {tol}")
            worst = max(worst, err)
            ms = time_ms(lambda i: int8_matmul(x, qs[i % n_cp], s), 50)
            plain = time_ms(lambda i: int8_matmul_plain(x, qs[i % n_cp], s),
                            10)
            ws = [(q.float() * s).to(torch.bfloat16) for q in qs[:max(
                1, n_cp // 2)]]
            lib = time_ms(lambda i: torch.matmul(x, ws[i % len(ws)]), 50)
            del ws
            nbytes = k * n + 4 * n + 2 * m * k + 2 * m * n
            ops = 2 * m * k * n
            b_ms, by = bound(nbytes, ops)
            log(f"  ms={ms:.6g} plain_ms={plain:.6g} library_ms={lib:.6g} "
                f"bound_ms={b_ms:.6g} ({by})")
            if m == SLOTS:
                calls = per_layer * LAYERS
                for key, val in (("ms", ms), ("plain_ms", plain),
                                 ("library_ms", lib), ("bound_ms", b_ms),
                                 ("bytes", nbytes), ("ops", ops)):
                    step[key] += calls * val
    b_ms, by = bound(step["bytes"], step["ops"])
    results["int8_matmul"] = {
        "max_abs_err": worst, "ms": step["ms"], "plain_ms": step["plain_ms"],
        "bound_ms": b_ms, "bound_by": by, "library_ms": step["library_ms"],
        "work": "one decode step at M=16: 112 calls over the 4 (K, N) shapes"}


def check_int8_matmul_t(results: dict) -> None:
    from fasttalk_tpu_torch.ops.cuda_int8 import (int8_matmul_t,
                                                  int8_matmul_t_plain)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randint(-127, 128, (VOCAB, HIDDEN), generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand((VOCAB,), generator=g, device=dev) * 0.02 + 1e-3
    worst = 0.0
    entry = None
    for m in (SLOTS, 1):
        x = torch.randn((m, HIDDEN), generator=g, device=dev).to(torch.bfloat16)
        got = int8_matmul_t(x, q, s).float()
        ref = int8_matmul_t_plain(x, q, s).float()
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = 1e-2 * ref.abs().max().item()
        log(f"int8_matmul_t M={m} V={VOCAB} D={HIDDEN}: max_abs_err={err:.6g} "
            f"(tol {tol:.6g})")
        if not err <= tol:
            fail(f"int8_matmul_t disagrees with its plain version at M={m}: "
                 f"{err} > {tol}")
        worst = max(worst, err)
        ms = time_ms(lambda i: int8_matmul_t(x, q, s), 20)
        plain = time_ms(lambda i: int8_matmul_t_plain(x, q, s), 3, warmup=1)
        w = (q.float() * s[:, None]).to(torch.bfloat16)
        lib = time_ms(lambda i: torch.nn.functional.linear(x, w), 20)
        del w
        nbytes = VOCAB * HIDDEN + 4 * VOCAB + 2 * m * HIDDEN + 2 * m * VOCAB
        b_ms, by = bound(nbytes, 2 * m * VOCAB * HIDDEN)
        log(f"  ms={ms:.6g} plain_ms={plain:.6g} library_ms={lib:.6g} "
            f"bound_ms={b_ms:.6g} ({by})")
        if m == SLOTS:
            entry = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                     "bound_by": by, "library_ms": lib,
                     "work": "one call at M=16 (the decode step's lm_head)"}
    entry["max_abs_err"] = worst
    results["int8_matmul_t"] = entry


def check_decode_attend(results: dict) -> None:
    from fasttalk_tpu_torch.ops.cuda_attention import (decode_attend,
                                                       decode_attend_plain)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    base = [1, 127, 128, 129, 2048, 1000, 511, 512, 513, 64, 300, 1500, 2047,
            33, 900, 1777]
    kv_bytes = SLOTS * MAX_LEN * NKV * HEAD_DIM * 2
    n_cp = copies_for(2 * kv_bytes)
    ks = [torch.randn((SLOTS, MAX_LEN, NKV, HEAD_DIM), generator=g,
                      device=dev).to(torch.bfloat16) for _ in range(n_cp)]
    vs = [torch.randn((SLOTS, MAX_LEN, NKV, HEAD_DIM), generator=g,
                      device=dev).to(torch.bfloat16) for _ in range(n_cp)]
    worst = 0.0
    entry = None
    for t in (1, 4):
        lens = [max(t, n) for n in base]
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn((SLOTS, t, NQ, HEAD_DIM), generator=g,
                        device=dev).to(torch.bfloat16)
        got = decode_attend(q, ks[0], vs[0], lengths).float()
        ref = decode_attend_plain(q, ks[0], vs[0], lengths).float()
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        gaps = attend_slot_gaps(got, ref)
        worst_slot = int(gaps.argmax())
        log(f"decode_attend B={SLOTS} S={MAX_LEN} T={t} lengths={lens}: "
            f"max_abs_err={err:.6g}; per slot max|err|/max|ref| "
            f"{[round(g, 6) for g in gaps.tolist()]}, worst "
            f"{gaps[worst_slot].item():.6g} at length {lens[worst_slot]} "
            f"(tol {ATTEND_SLOT_TOL})")
        if not bool((gaps <= ATTEND_SLOT_TOL).all()):
            fail(f"decode_attend disagrees with its plain version at T={t}: "
                 f"slot gaps {gaps.tolist()} > {ATTEND_SLOT_TOL}")
        worst = max(worst, err)
        ms = time_ms(lambda i: decode_attend(q, ks[i % n_cp], vs[i % n_cp],
                                             lengths), 50)
        plain = time_ms(lambda i: decode_attend_plain(
            q, ks[i % n_cp], vs[i % n_cp], lengths), 5)
        # Library yardstick: SDPA with GQA over [B, H, S, D] layouts and a
        # boolean length mask (it reads the whole S; it cannot prune).
        kt = [k.transpose(1, 2).contiguous() for k in ks[:2]]
        vt = [v.transpose(1, 2).contiguous() for v in vs[:2]]
        qt = q.transpose(1, 2)
        horizon = (lengths[:, None] - (t - 1)
                   + torch.arange(t, device=dev)[None])
        mask = (torch.arange(MAX_LEN, device=dev)[None, None, None, :]
                < horizon[:, None, :, None])
        lib = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
            qt, kt[i % 2], vt[i % 2], attn_mask=mask, enable_gqa=True), 50)
        del kt, vt
        live = sum(lens)
        nbytes = (2 * live * NKV * HEAD_DIM * 2 + 2 * q.numel() * 2
                  + 4 * SLOTS)
        ops = 4 * live * NQ * HEAD_DIM * t
        b_ms, by = bound(nbytes, ops)
        log(f"  ms={ms:.6g} plain_ms={plain:.6g} library_ms={lib:.6g} "
            f"bound_ms={b_ms:.6g} ({by})")
        if t == 1:
            calls = LAYERS
            entry = {"ms": calls * ms, "plain_ms": calls * plain,
                     "bound_ms": calls * b_ms, "bound_by": by,
                     "library_ms": calls * lib,
                     "work": "one decode step at T=1: 16 calls, B=16, "
                             f"lengths {lens}"}
    entry["max_abs_err"] = worst
    results["decode_attend"] = entry


# ---------------------------------------------------------------- phase 3

@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel call sites to the plain versions."""
    from fasttalk_tpu_torch.models import llama
    from fasttalk_tpu_torch.ops import cuda_attention, cuda_int8, quant

    saved = (quant.int8_matmul, quant.int8_matmul_t, llama.decode_attend)
    quant.int8_matmul = cuda_int8.int8_matmul_plain
    quant.int8_matmul_t = cuda_int8.int8_matmul_t_plain
    llama.decode_attend = cuda_attention.decode_attend_plain
    try:
        yield
    finally:
        quant.int8_matmul, quant.int8_matmul_t, llama.decode_attend = saved


def check_full_width_model() -> None:
    from fasttalk_tpu_torch.models import llama
    from fasttalk_tpu_torch.models.configs import get_model_config
    from fasttalk_tpu_torch.models.loader import init_params_device

    dev = torch.device("cuda")
    cfg = get_model_config("llama3.2:1b")
    t0 = time.monotonic()
    params = init_params_device(cfg, torch.bfloat16, dev, quantize=True,
                                seed=0)
    torch.cuda.synchronize()
    log(f"llama3.2:1b int8 random init on the card: "
        f"{time.monotonic() - t0:.3f} s")
    g = torch.Generator(device=dev).manual_seed(4)
    b, t, steps = SLOTS, 64, 4
    prompt = torch.randint(0, 32000, (b, t), generator=g, device=dev)
    pos = torch.arange(t, device=dev)[None].expand(b, t)
    caches = [llama.init_cache(cfg, b, MAX_LEN, torch.bfloat16, dev)
              for _ in range(2)]
    logits = []
    for cache, ctx in ((caches[0], contextlib.nullcontext()),
                       (caches[1], plain_kernels())):
        with ctx:
            out = []
            lg, _ = llama.forward(params, cfg, prompt, pos, cache,
                                  torch.zeros(b, dtype=torch.long, device=dev),
                                  blockwise=True,
                                  logits_indices=torch.full(
                                      (b,), t - 1, device=dev))
            out.append(lg[:, 0])
            logits.append(out)
    # Decode: both paths are fed the kernel path's greedy tokens.
    cur = logits[0][0].argmax(-1)
    mask = torch.ones(b, dtype=torch.bool, device=dev)
    for i in range(steps):
        p = torch.full((b,), t + i, dtype=torch.long, device=dev)
        lk, _ = llama.forward_decode(params, cfg, cur, p, caches[0], mask,
                                     attn_len=512)
        with plain_kernels():
            lp, _ = llama.forward_decode(params, cfg, cur, p, caches[1], mask,
                                         attn_len=512)
        logits[0].append(lk)
        logits[1].append(lp)
        cur = lk.argmax(-1)
    torch.cuda.synchronize()
    agree = total = 0
    for i, (lk, lp) in enumerate(zip(*logits)):
        span = (lp.max() - lp.min()).item()
        err = (lk - lp).abs().max().item()
        same = (lk.argmax(-1) == lp.argmax(-1)).sum().item()
        agree += same
        total += lk.shape[0]
        log(f"llama3.2:1b {'prefill' if i == 0 else f'decode {i}'}: "
            f"max|kernel-plain|={err:.6g} logit range={span:.6g} "
            f"greedy agree {same}/{lk.shape[0]}")
        if not (math.isfinite(err) and err <= 0.05 * span):
            fail(f"full-width logits differ beyond 5% of the range: {err}")
    if agree < 0.9 * total:
        fail(f"greedy tokens agree on only {agree}/{total} rows")
    del params, caches


# ------------------------------------------------------------- phase 4/5

def check_tinychat() -> None:
    from fasttalk_tpu_torch.engine.engine import GenerationParams
    from fasttalk_tpu_torch.engine.factory import build_engine
    from fasttalk_tpu_torch.utils.config import Config

    engine = build_engine(Config(model_name="tinychat", model_path=ASSETS,
                                 weight_quant="int8", decode_slots=4,
                                 max_model_len=512,
                                 default_context_window=512), device="cuda")
    engine.start()
    try:
        async def run():
            text, final = "", {}
            async for ev in engine.generate(
                    "sky", "sky", [{"role": "user",
                                    "content": "what color is the sky?"}],
                    GenerationParams(max_tokens=48, temperature=0.0,
                                     top_k=0, top_p=1.0)):
                if ev["type"] == "token":
                    text += ev["text"]
                else:
                    final = ev
            return text, final
        text, final = asyncio.run(asyncio.wait_for(run(), timeout=120))
    finally:
        engine.shutdown()
    log(f"tinychat int8 greedy: {text!r} ({final.get('finish_reason')})")
    if final.get("type") != "done" or "blue" not in text.lower():
        fail(f"tinychat answer is wrong: {text!r} {final}")


async def drive_sessions(port: int, n: int, max_tokens: int) -> dict:
    import aiohttp

    prompts = ["Tell me about the ocean.", "What is a good breakfast?",
               "Explain how trains work.", "Write a short poem about rain.",
               "Why is the sky blue?", "Give me three tips for sleep.",
               "What is your favourite book?", "How do plants grow?"]

    async def one(i: int, http) -> tuple[int, list[str]]:
        errors = []
        tokens = 0
        async with http.ws_connect(f"ws://127.0.0.1:{port}/ws/llm") as ws:
            first = json.loads((await ws.receive()).data)
            if first["type"] != "session_started":
                errors.append(str(first))
            await ws.send_json({"type": "start_session", "config": {
                "max_tokens": max_tokens, "temperature": 0.7,
                "ignore_eos": True}})
            json.loads((await ws.receive()).data)
            await ws.send_json({"type": "user_message",
                                "text": prompts[i % len(prompts)]})
            while True:
                m = json.loads((await ws.receive()).data)
                if m["type"] == "token":
                    continue
                if m["type"] == "response_complete":
                    tokens = m["stats"]["tokens_generated"]
                else:
                    errors.append(json.dumps(m))
                break
            await ws.send_json({"type": "end_session"})
            json.loads((await ws.receive()).data)
        return tokens, errors

    async with aiohttp.ClientSession() as http:
        t0 = time.monotonic()
        res = await asyncio.gather(*(one(i, http) for i in range(n)))
        wall = time.monotonic() - t0
    return {"sessions": n, "tokens": sum(r[0] for r in res),
            "errors": [e for r in res for e in r[1]], "wall_s": wall}


def serve_main_path(drive):
    """Serve the main path and return ``await drive(engine, port)``.

    Builds the engine through ``build_engine`` as ``python -m
    fasttalk_tpu_torch websocket`` does (llama3.2:1b at full width, int8
    random weights, 16 slots, max_len 2048, prefill chunk 512), serves it
    on an ephemeral localhost port, runs one short warm-up session (the
    first CUDA launches), then hands the port to ``drive``. Server and
    engine are stopped before this returns.
    """
    from aiohttp import web

    from fasttalk_tpu_torch.engine.factory import build_engine
    from fasttalk_tpu_torch.serving.server import WebSocketLLMServer
    from fasttalk_tpu_torch.utils.config import Config

    cfg = Config(model_name="llama3.2:1b", model_path="", weight_quant="int8",
                 decode_slots=SLOTS, max_model_len=MAX_LEN, prefill_chunk=512,
                 default_context_window=MAX_LEN, default_max_tokens=64)
    t0 = time.monotonic()
    engine = build_engine(cfg, device="cuda")
    log(f"build_engine (llama3.2:1b int8, 16 slots, max_len 2048): "
        f"{time.monotonic() - t0:.3f} s")
    engine.start()

    async def run():
        runner = web.AppRunner(WebSocketLLMServer(cfg, engine).app)
        await runner.setup()
        try:
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            port = site._server.sockets[0].getsockname()[1]
            warm = await drive_sessions(port, 1, 8)
            if warm["errors"]:
                fail(f"warm-up session failed: {warm['errors']}")
            return await drive(engine, port)
        finally:
            await runner.cleanup()

    try:
        return asyncio.run(asyncio.wait_for(run(), timeout=600))
    finally:
        engine.shutdown()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "fasttalk_tpu_torch")):
        print("chip_smoke: fasttalk_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from fasttalk_tpu_torch.ops import _build
    from fasttalk_tpu_torch.ops.cuda_attention import decode_attend
    from fasttalk_tpu_torch.ops.cuda_int8 import int8_matmul, int8_matmul_t

    t0 = time.monotonic()
    libs = _build.build()
    log(f"built {sorted(libs)} in {time.monotonic() - t0:.3f} s")

    results: dict = {}
    check_int8_matmul(results)
    check_int8_matmul_t(results)
    check_decode_attend(results)
    torch.cuda.empty_cache()
    check_full_width_model()
    torch.cuda.empty_cache()
    check_tinychat()
    counters = [int8_matmul, int8_matmul_t, decode_attend]

    async def measured(engine, port: int) -> dict:
        for fn in counters:
            fn.launches = 0
        out = await drive_sessions(port, SLOTS, 64)
        out["launches"] = {fn.__name__: fn.launches for fn in counters}
        return out

    served = serve_main_path(measured)
    tok_s = served["tokens"] / served["wall_s"]
    log(f"served {served['sessions']} concurrent WS sessions: "
        f"{served['tokens']} tokens in {served['wall_s']:.6g} s "
        f"({tok_s:.6g} decode tok/s), error frames: {len(served['errors'])}")
    if served["errors"]:
        fail(f"error frames: {served['errors'][:3]}")
    if served["tokens"] <= 0:
        fail("no tokens served")
    for name, n in served["launches"].items():
        log(f"launches on the served path: {name}={n}")
        if n <= 0:
            fail(f"kernel {name} never launched on the served path")

    sources = {"int8_matmul": ("fasttalk_tpu_torch/csrc/int8_matmul.cu",
                               "fasttalk_tpu/ops/pallas_int8.py:89"),
               "int8_matmul_t": ("fasttalk_tpu_torch/csrc/int8_matmul.cu",
                                 "fasttalk_tpu/ops/pallas_int8.py:127"),
               "decode_attend": ("fasttalk_tpu_torch/csrc/decode_attention.cu",
                                 "fasttalk_tpu/ops/pallas_attention.py:153")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": served["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "work": r["work"], "card": card})
    print(json.dumps({"kernels": kernels, "served": {
        "sessions": served["sessions"], "tokens": served["tokens"],
        "wall_s": served["wall_s"], "decode_tok_s": tok_s}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
