"""Rank processes of the port's multi-rank tests on the CPU.

``spawn`` (the test side) starts ``world`` ranks of one gloo process
group and waits for them under a hard deadline; each rank runs
``python -m tests._torch_ranks SCENARIO OUTDIR`` (or the command the test
gives) with ``TPU_COORDINATOR_ADDR`` / ``TPU_NUM_PROCESSES`` /
``TPU_PROCESS_ID`` set, one intra-op thread (``OMP_NUM_THREADS=1``,
``torch.set_num_threads(1)``), a lower scheduling priority (``nice``), a
coordinator port from the OS, and its output in ``OUTDIR/rankN.log``. A rank that is still running at the
deadline is killed with its process group and the test fails with the
ranks' log tails; no rank outlives ``spawn``.

The ranks import the port only (never ``jax`` or ``fasttalk_tpu``); the
tests hold what they write against the JAX package in the test process.

Scenarios:

- ``model``: sharded forwards and attention over several meshes of the
  4-rank world (tests/test_torch_parallel.py);
- ``serve``: the SPMD leader over the port's engine or its launcher; a
  follower is ``python -m fasttalk_tpu_torch websocket`` with
  ``TPU_SPMD_ROLE=follower`` (tests/test_torch_spmd.py).
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "fasttalk_tpu", "assets")


def free_ports(n: int) -> list[int]:
    """``n`` distinct ports from the OS (all bound at once, then freed)."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _tails(outdir: str, world: int) -> str:
    out = []
    for r in range(world):
        path = os.path.join(outdir, f"rank{r}.log")
        try:
            with open(path, encoding="utf-8", errors="replace") as f:
                out.append(f"--- rank {r} ---\n" + f.read()[-3000:])
        except OSError:
            out.append(f"--- rank {r}: no log ---")
    return "\n".join(out)


def spawn(scenario: str, world: int, outdir: str, *, timeout: float = 120,
          env: dict | None = None, rank_env=None, argv=None) -> list[str]:
    """Run ``world`` ranks to their end within ``timeout`` seconds and
    return their logs. ``rank_env(r)``: extra environment of rank r;
    ``argv(r)``: its command instead of the scenario's (None: the
    scenario's). Fails (raises
    AssertionError) on a timeout or a non-zero exit."""
    os.makedirs(outdir, exist_ok=True)
    (port,) = free_ports(1)
    procs, handles = [], []
    try:
        for r in range(world):
            e = dict(os.environ)
            e.update({"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
                      "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
                      "TPU_COORDINATOR_ADDR": f"127.0.0.1:{port}",
                      "TPU_NUM_PROCESSES": str(world),
                      "TPU_PROCESS_ID": str(r)})
            e.update(env or {})
            if rank_env is not None:
                e.update(rank_env(r))
            cmd = (argv(r) if argv is not None else None) or [
                sys.executable, "-m", "tests._torch_ranks", scenario, outdir]
            # Below the test processes' priority: the ranks must not starve
            # the timing-sensitive tests that other workers run meanwhile.
            cmd = ["nice", "-n", "10", *cmd]
            fh = open(os.path.join(outdir, f"rank{r}.log"), "w")
            handles.append(fh)
            procs.append(subprocess.Popen(
                cmd, cwd=REPO, env=e, stdout=fh, stderr=subprocess.STDOUT,
                start_new_session=True))
        deadline = time.monotonic() + timeout
        for p in procs:
            left = deadline - time.monotonic()
            try:
                p.wait(timeout=max(0.1, left))
            except subprocess.TimeoutExpired:
                raise AssertionError(
                    f"{scenario}: ranks still running after {timeout:.0f}s"
                    f"\n{_tails(outdir, world)}") from None
        codes = [p.returncode for p in procs]
        if any(codes):
            raise AssertionError(f"{scenario}: rank exit codes {codes}\n"
                                 f"{_tails(outdir, world)}")
    finally:
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except OSError:
                    pass
                p.wait()
        for fh in handles:
            fh.close()
    logs = []
    for r in range(world):
        with open(os.path.join(outdir, f"rank{r}.log"), encoding="utf-8",
                  errors="replace") as f:
            logs.append(f.read())
    return logs


# ------------------------------------------------------------------ ranks


def _mesh_or_none(spec):
    """This rank's mesh, or None when the rank is outside it (every rank
    still takes part in creating the groups)."""
    from fasttalk_tpu_torch.parallel.mesh import make_mesh

    try:
        return make_mesh(spec)
    except ValueError as e:
        if "is outside mesh" in str(e):
            return None
        raise


def _unflatten(flat: dict, prefix: str) -> dict:
    import torch

    out: dict = {}
    for key, arr in flat.items():
        if not key.startswith(prefix):
            continue
        node = out
        *parents, leaf = key[len(prefix):].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(arr.copy())
    return out


def _flat_items(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _model(outdir: str) -> None:
    """Sharded prefill and decode logits of test-tiny (the JAX init) and
    tinychat (the JAX load), float32 and int8, on a tp=2
    and a dp=2 x tp=2 mesh, and the ring and sharded decode attention on
    an sp=4 and a dp=2 x sp=2 mesh. Each rank writes what it computed."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from fasttalk_tpu_torch.models import llama
    from fasttalk_tpu_torch.models.configs import get_model_config
    from fasttalk_tpu_torch.parallel import collectives
    from fasttalk_tpu_torch.parallel.mesh import MeshSpec
    from fasttalk_tpu_torch.parallel.ring_attention import (
        decode_attention_sharded, ring_attention_sharded)
    from fasttalk_tpu_torch.parallel.sharding import shard_params

    rank = dist.get_rank()
    inp = dict(np.load(os.path.join(outdir, "inputs.npz")))
    out: dict[str, np.ndarray] = {}
    cfgs = {"tiny": get_model_config("test-tiny"),
            "chat": get_model_config("tinychat", ASSETS)}
    for mname, spec in (("tp2", MeshSpec(tp=2)),
                        ("dp2tp2", MeshSpec(dp=2, tp=2))):
        mesh = _mesh_or_none(spec)
        if mesh is None:
            continue
        for model, cfg in cfgs.items():
            for quant in ("f32", "int8"):
                # The JAX package's params (its init or its load, float32
                # or its int8 quantization), cut to this rank's shards.
                params = shard_params(_unflatten(inp, f"{model}/{quant}/"),
                                      mesh)
                toks = torch.from_numpy(inp[f"{model}_tokens"])
                dec = torch.from_numpy(inp[f"{model}_dec"])
                b = toks.shape[0] // spec.dp
                rows = slice(mesh.coords["dp"] * b,
                             (mesh.coords["dp"] + 1) * b)
                t = toks.shape[1]
                local = dataclasses.replace(
                    cfg, num_kv_heads=cfg.num_kv_heads // spec.tp)
                cache = llama.init_cache(local, b, 64, torch.float32, "cpu")
                logits, _ = llama.forward(
                    params, cfg, toks[rows],
                    torch.arange(t)[None].expand(b, t), cache,
                    torch.zeros(b, dtype=torch.long), mesh=mesh)
                step, _ = llama.forward_decode(
                    params, cfg, dec[rows], torch.full((b,), t), cache,
                    torch.ones(b, dtype=torch.bool), attn_len=64, mesh=mesh)
                key = f"{mname}/{model}/{quant}"
                out[f"{key}/prefill"] = logits.numpy()
                out[f"{key}/decode"] = step.numpy()
                out[f"{key}/cache_k"] = cache.k.numpy()
    # tinychat int8 with bf16 activations, as served: tp = 2 against the
    # whole model on one rank, each on the same rows.
    mesh = _mesh_or_none(MeshSpec(tp=2))
    if mesh is not None:
        cfg = cfgs["chat"]
        # Scales stay float32, as the loader keeps them.
        whole = {k: v if v.dtype == torch.int8 or k.endswith("/s")
                 else v.to(torch.bfloat16)
                 for k, v in _flat_items(_unflatten(inp, "chat/int8/"))}
        whole = _nest(whole)
        toks = torch.from_numpy(inp["chat_tokens"])
        dec = torch.from_numpy(inp["chat_dec"])
        b, t = toks.shape
        for name, m, params in (("single", None, whole),
                                ("tp2", mesh, shard_params(whole, mesh))):
            kv = cfg.num_kv_heads // (2 if m is not None else 1)
            cache = llama.init_cache(dataclasses.replace(
                cfg, num_kv_heads=kv), b, 64, torch.bfloat16, "cpu")
            logits, _ = llama.forward(
                params, cfg, toks, torch.arange(t)[None].expand(b, t), cache,
                torch.zeros(b, dtype=torch.long), mesh=m)
            step, _ = llama.forward_decode(
                params, cfg, dec, torch.full((b,), t), cache,
                torch.ones(b, dtype=torch.bool), attn_len=64, mesh=m)
            out[f"{name}/chat/int8bf16/prefill"] = logits.float().numpy()
            out[f"{name}/chat/int8bf16/decode"] = step.float().numpy()
    for mname, spec in (("sp4", MeshSpec(sp=4)),
                        ("dp2sp2", MeshSpec(dp=2, sp=2))):
        mesh = _mesh_or_none(spec)
        sp, i = spec.sp, mesh.coords["sp"]
        q, k, v = (torch.from_numpy(inp[f"ring_{x}"]) for x in "qkv")
        pos = torch.from_numpy(inp["ring_pos"])
        c = q.shape[1] // sp
        sl = slice(i * c, (i + 1) * c)
        out[f"{mname}/ring"] = ring_attention_sharded(
            q[:, sl], k[:, sl], v[:, sl], pos[:, sl], mesh).numpy()
        dq, dk, dv = (torch.from_numpy(inp[f"dec_{x}"]) for x in "qkv")
        s = dk.shape[1] // sp
        ss = slice(i * s, (i + 1) * s)
        out[f"{mname}/decode"] = decode_attention_sharded(
            dq, dk[:, ss], dv[:, ss], torch.from_numpy(inp["dec_pos"]),
            mesh).numpy()
    out["collective_calls"] = np.array(collectives.stats()["calls"])
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)


async def ws_turns(connect, turns: list[list[str]],
                   greedy: dict) -> list[list[str]]:
    """Each session's turns through the WebSocket protocol, the sessions
    concurrently; returns each reply's text. ``connect()`` opens a
    WebSocket to ``/ws/llm``."""
    import asyncio

    async def session(msgs: list[str]) -> list[str]:
        ws = await connect()
        try:
            assert json.loads((await ws.receive()).data)["type"] \
                == "session_started"
            await ws.send_json({"type": "start_session",
                                "config": {"max_tokens": 24, **greedy}})
            await ws.receive()
            replies = []
            for text in msgs:
                await ws.send_json({"type": "user_message", "text": text})
                got = ""
                while True:
                    f = json.loads((await ws.receive(timeout=120)).data)
                    if f["type"] == "token":
                        got += f["data"]
                    elif f["type"] == "response_complete":
                        break
                    elif f["type"] == "error":
                        raise RuntimeError(f)
                replies.append(got)
            return replies
        finally:
            await ws.close()

    return list(await asyncio.gather(*(session(m) for m in turns)))


GREEDY = {"temperature": 0.0, "top_k": 0, "top_p": 1.0}


def _serve(outdir: str) -> None:
    """The SPMD leader. ``SERVE_VIA=launcher``: the port's ServerLauncher
    (the product surface) with the WebSocket turns of ``turns.json``
    driven against it; ``SERVE_VIA=engine``: ``build_engine`` with a
    ``CallBroadcaster`` and the engine's ``generate`` over the messages of
    ``prompts.json``, concurrently. Writes ``leader.json``."""
    import asyncio

    from fasttalk_tpu_torch.utils.config import Config

    with open(os.path.join(outdir, "work.json"), encoding="utf-8") as f:
        work = json.load(f)
    config = Config()
    if os.environ["SERVE_VIA"] == "launcher":
        import aiohttp

        from fasttalk_tpu_torch.serving.launcher import ServerLauncher

        launcher = ServerLauncher(config, device="cpu")

        async def main():
            task = asyncio.ensure_future(launcher.run())
            while "serving" not in launcher.addresses:
                assert not task.done(), task.result()
                await asyncio.sleep(0.05)
            host, port = launcher.addresses["serving"][:2]
            async with aiohttp.ClientSession() as http:
                replies = await ws_turns(
                    lambda: http.ws_connect(f"http://{host}:{port}/ws/llm"),
                    work, GREEDY)
            stats = launcher.engine.get_stats()
            launcher.stop()
            await task
            return {"replies": replies, "decode_calls": stats["decode_calls"]}

        result = asyncio.run(main())
    else:
        from fasttalk_tpu_torch.engine.engine import GenerationParams
        from fasttalk_tpu_torch.engine.factory import build_engine
        from fasttalk_tpu_torch.parallel.spmd_serving import CallBroadcaster

        eng = build_engine(config, device="cpu")
        host, port = config.spmd_addr.rsplit(":", 1)
        sink = CallBroadcaster(host, int(port), config.spmd_followers,
                               hb_interval_s=config.spmd_hb_interval_s)
        eng.call_sink = sink

        async def chat(i, msgs):
            text = ""
            async for ev in eng.generate(
                    f"r{i}", f"s{i}", msgs,
                    GenerationParams(max_tokens=24, **GREEDY)):
                if ev["type"] == "token":
                    text += ev["text"]
                elif ev["type"] == "error":
                    raise RuntimeError(ev)
            return text

        async def main():
            return list(await asyncio.gather(
                *(chat(i, m) for i, m in enumerate(work))))

        eng.start()
        try:
            replies = asyncio.run(main())
            result = {"replies": replies,
                      "decode_calls": eng.get_stats()["decode_calls"],
                      "ring_prefill_calls": eng.ring_prefill_calls,
                      "mesh": eng.get_model_info()["mesh"]}
        finally:
            eng.shutdown()
            sink.close()
    with open(os.path.join(outdir, "leader.json"), "w",
              encoding="utf-8") as f:
        json.dump(result, f)


def main() -> int:
    import torch

    torch.set_num_threads(1)
    scenario, outdir = sys.argv[1], sys.argv[2]
    from fasttalk_tpu_torch.parallel.distributed import (maybe_initialize,
                                                         shutdown)

    maybe_initialize()
    try:
        {"model": _model, "serve": _serve}[scenario](outdir)
    finally:
        shutdown()
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "fasttalk_tpu")]
    assert not bad, f"a rank imported the JAX package: {bad[:5]}"
    return 0


if __name__ == "__main__":
    sys.exit(main())
