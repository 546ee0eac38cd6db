"""The serving engine: continuous batching over fixed decode slots.

Counterpart of the main-path subset of ``fasttalk_tpu/engine/engine.py``
(``TPUEngine``, :373):

- **One engine thread** owns every device interaction; asyncio callers
  talk to it through a command queue, and token deltas travel back with
  ``loop.call_soon_threadsafe`` onto per-request ``asyncio.Queue``s.
- **FIFO admission into slots.** Sessions pin slots (engine/slots.py), so
  a follow-up turn prefills only the token delta after its resident
  prefix.
- **Chunked prefill**, one chunk per loop iteration, so running sessions
  keep streaming while a long prompt prefills.
- **K decode steps per call**, with the per-slot decode state (current
  token, positions, sampling parameters, penalty counts, the generator)
  kept on the device between steps and calls. Up to ``pipeline_depth``
  calls are enqueued on the CUDA stream before the host reads the oldest
  call's tokens (an asynchronous copy into pinned memory plus an event).
  Host mirrors of the slot state are reconciled at retirement and patched
  onto the device only when the slot set changes.
- Retire/detokenize, stop strings, EOS, ``max_tokens``, ``cancel`` and
  ``release_session`` behave as in the JAX engine.
- **Weight tiers**: bf16, int8, or int4 group-wise leaves for the seven
  layer matmuls (quantization/int4.py), read from the params' leaves; the
  model routes each leaf to its matmul (ops/quant.py), and ``/models``
  reports the tier.
- **KV tiers** (JAX ``engine.py`` :465-581, :2826-3206): ``kv_quant="int8"``
  stores int8 rows + f32 row scales (prefill and decode write the scales,
  the kernels dequantize after the load); ``kv_layout="paged"`` replaces
  the per-slot cache with one block pool and per-slot block tables
  (kvcache/blocks.py). Paged admission is by blocks: the prompt's padded
  prefill horizon plus the reserve policy's decode growth must fit, else
  the request ends with ``code="kv_blocks_exhausted"`` and ``retry_after``.
  Before each decode call every running slot's blocks are ensured out to
  where the device can be by the end of it (the host mirrors lag the
  in-flight calls); a prefill chunk ensures ``start + bucket`` and runs as
  gather -> dense ``forward`` -> scatter of the chunk's rows. Blocks go
  back on session eviction and release, and past the trusted rows when a
  request finishes or a prompt diverges from the resident history.

Speculative decoding, host KV offload, the radix cache, shared-prefix
aliasing, structured decoding and a device mesh are not part of this
engine (utils/config.py rejects them by name).
"""

from __future__ import annotations

import asyncio
import math
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, AsyncGenerator

import numpy as np
import torch

from fasttalk_tpu_torch.engine.slots import Slot, SlotManager
from fasttalk_tpu_torch.engine.tokenizer import StreamDetokenizer, Tokenizer
from fasttalk_tpu_torch.kvcache.blocks import BlockAllocator, blocks_for
from fasttalk_tpu_torch.models.configs import ModelConfig
from fasttalk_tpu_torch.models.llama import (KVCache, forward, forward_decode,
                                             init_cache, init_paged_cache)
from fasttalk_tpu_torch.ops.attention import paged_gather_indices
from fasttalk_tpu_torch.ops.kv_quant import granule_dim
from fasttalk_tpu_torch.ops.sampling import apply_penalties, sample_tokens
from fasttalk_tpu_torch.quantization.int4 import (group_size_of, is_int4,
                                                  validate_group)
from fasttalk_tpu_torch.utils.config import resolve_device
from fasttalk_tpu_torch.utils.errors import ErrorCategory, LLMServiceError
from fasttalk_tpu_torch.utils.logger import get_logger

log = get_logger("engine")

_KV_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 32768)
_PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)
# Candidate preselection of the sampler: block-max ("fast"), the JAX
# engine's serving default; greedy top-1 is exact either way.
_SAMPLING = "fast"


@dataclass
class GenerationParams:
    temperature: float = 0.7
    top_k: int = 40
    top_p: float = 0.9
    max_tokens: int = 2048
    stop: list[str] = field(default_factory=list)
    repeat_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    ignore_eos: bool = False

    def __post_init__(self) -> None:
        if not (math.isfinite(self.repeat_penalty)
                and 0.0 < self.repeat_penalty <= 2.0):
            raise ValueError(f"repeat_penalty must be in (0, 2], got "
                             f"{self.repeat_penalty}")
        if not math.isfinite(self.presence_penalty):
            raise ValueError("presence_penalty must be finite")
        if not math.isfinite(self.frequency_penalty):
            raise ValueError("frequency_penalty must be finite")
        if self.max_tokens <= 0:
            raise ValueError(f"max_tokens must be > 0, got {self.max_tokens}")


@dataclass(eq=False)
class _Request:
    request_id: str
    session_id: str
    prompt_tokens: list[int]
    params: GenerationParams
    out_queue: asyncio.Queue
    loop: asyncio.AbstractEventLoop
    submitted_at: float = field(default_factory=time.monotonic)
    admitted_at: float = 0.0
    detok: StreamDetokenizer | None = None
    slot: Slot | None = None
    generated: int = 0
    pending_text: str = ""     # held back for stop-string matching
    emit_buf: str = ""         # text batched within one retirement
    first_token_at: float | None = None
    first_pending: bool = False  # first sampled token not yet fetched
    cancelled: bool = False
    finished: bool = False
    prefill_tokens: int = 0


@dataclass
class _PrefillState:
    req: _Request
    slot: Slot
    start: int
    todo: list[int]
    last_logits: Any = None


class EngineBase:
    """The engine seam the serving layer depends on."""

    async def generate(self, request_id: str, session_id: str,
                       messages: list[dict], params: GenerationParams,
                       ) -> AsyncGenerator[dict, None]:
        raise NotImplementedError
        yield  # pragma: no cover

    def cancel(self, request_id: str) -> bool:
        raise NotImplementedError

    def release_session(self, session_id: str) -> None:
        raise NotImplementedError

    def check_connection(self) -> bool:
        raise NotImplementedError

    def get_model_info(self) -> dict:
        raise NotImplementedError

    def get_stats(self) -> dict:
        raise NotImplementedError

    def start(self) -> None:
        raise NotImplementedError

    def shutdown(self) -> None:
        raise NotImplementedError


class _HostCopy:
    """A device tensor's copy to the host, started without waiting: on
    CUDA into pinned memory behind an event, on the CPU a plain clone."""

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t.clone()
            self._event = None

    def done(self) -> bool:
        return self._event is None or self._event.query()

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class TorchEngine(EngineBase):
    """The port's engine. Owns params, KV cache, tokenizer, decode loop."""

    def __init__(self, model_cfg: ModelConfig, params: Any,
                 tokenizer: Tokenizer, *, device: str | torch.device | None = None,
                 num_slots: int = 16, max_len: int = 8192,
                 prefill_chunk: int = 512,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 context_window: int | None = None,
                 steps_per_call: int = 32, pipeline_depth: int = 2,
                 kv_quant: str = "none", kv_quant_granule: str = "token",
                 kv_layout: str = "dense", kv_block_size: int = 16,
                 kv_pool_blocks: int = 0, kv_reserve_policy: str = "fixed",
                 kv_reserve_tokens: int = 128):
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.params = params
        self.tokenizer = tokenizer
        self.num_slots = num_slots
        # Cache length rounds up to the KV bucket granule, as in the JAX
        # engine; the request-visible limit stays the configured length.
        self.max_len = -(-max_len // _KV_BUCKETS[0]) * _KV_BUCKETS[0]
        self.usable_len = min(max_len, context_window or max_len)
        self.prefill_chunk = min(prefill_chunk, max(_PREFILL_BUCKETS))
        self.dtype = dtype
        self.seed = seed
        self.steps_per_call = max(1, steps_per_call)
        self.steps_burst = min(8, self.steps_per_call)
        self.pipeline_depth = max(1, pipeline_depth)
        # Sampling is restricted to ids the tokenizer can decode (random
        # weights of a 128k-vocab model paired with a 32k tokenizer).
        self.sample_vocab = min(model_cfg.vocab_size,
                                getattr(tokenizer, "vocab_size",
                                        model_cfg.vocab_size))
        # The weight tier is the one the params carry, read from their
        # leaves (the JAX engine takes it as a setting, :443-464): int4
        # {"q4", "s"} with a group that fits the model's dims, int8
        # {"q", "s"}, or float. Every tier composes with both KV tiers and
        # both layouts.
        wq = params.get("layers", {}).get("wq")
        self.weight_quant_group = None
        if is_int4(params):
            self.weight_quant = "int4"
            self.weight_quant_group = group_size_of(wq)
            validate_group(model_cfg, self.weight_quant_group)
        else:
            self.weight_quant = "int8" if isinstance(wq, dict) else "off"
        if kv_quant not in ("none", "int8"):
            raise ValueError(f"kv_quant must be 'none' or 'int8', "
                             f"got {kv_quant!r}")
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be 'dense' or 'paged', "
                             f"got {kv_layout!r}")
        self.kv_quant = kv_quant == "int8"
        self.kv_scale_granule = (granule_dim(kv_quant_granule,
                                             model_cfg.num_kv_heads)
                                 if self.kv_quant else 1)
        self.paged = kv_layout == "paged"
        self.kv_block_size = int(kv_block_size)
        self._kv_blocks: BlockAllocator | None = None
        if self.paged:
            bs = self.kv_block_size
            if bs < 8 or bs > _KV_BUCKETS[0] or bs & (bs - 1):
                raise ValueError(f"KV_BLOCK_SIZE must be a power of two in "
                                 f"[8, {_KV_BUCKETS[0]}], got {bs}")
            if kv_reserve_policy not in ("none", "fixed", "max_tokens"):
                raise ValueError(f"kv_reserve_policy must be none|fixed|"
                                 f"max_tokens, got {kv_reserve_policy!r}")
            self.kv_reserve_policy = kv_reserve_policy
            self.kv_reserve_tokens = max(0, int(kv_reserve_tokens))
            # 0 = the dense-equivalent pool (the factory passes what the
            # memory budget holds).
            self.kv_pool_blocks = int(kv_pool_blocks) \
                or num_slots * self.max_len // bs
            self._kv_blocks = BlockAllocator(self.kv_pool_blocks, bs,
                                             num_slots)
            self.cache: KVCache = init_paged_cache(
                model_cfg, self.kv_pool_blocks, bs, dtype, self.device,
                quantized=self.kv_quant, scale_granule=self.kv_scale_granule)
        else:
            self.cache = init_cache(model_cfg, num_slots, self.max_len, dtype,
                                    self.device, quantized=self.kv_quant,
                                    scale_granule=self.kv_scale_granule)
        self._service_ema_s = 0.0
        self.slots = SlotManager(num_slots, self.max_len,
                                 on_unpin=self._on_slot_unpin)
        self._rows = torch.arange(num_slots, device=self.device)
        self._reset_decode_state()

        self._commands: queue.Queue = queue.Queue()
        self._waiting: deque[_Request] = deque()
        self._prefilling: list[_PrefillState] = []
        self._running: dict[int, _Request] = {}
        self._by_id: dict[str, _Request] = {}
        self._release_after: set[str] = set()
        self._thread: threading.Thread | None = None
        self._stopped = threading.Event()
        self._started = False
        self._term_lock = threading.Lock()
        self.tokens_generated = 0
        self.decode_calls = 0
        self.decode_steps = 0
        self.decode_host_s = 0.0   # host time spent enqueueing decode calls

    def _reset_decode_state(self) -> None:
        s, dev = self.num_slots, self.device
        self._positions = np.zeros((s,), np.int64)
        self._active_mask = np.zeros((s,), bool)
        self._temps = np.zeros((s,), np.float32)
        self._topks = np.zeros((s,), np.int64)
        self._topps = np.ones((s,), np.float32)
        self._reps = np.ones((s,), np.float32)
        self._press = np.zeros((s,), np.float32)
        self._freqs = np.zeros((s,), np.float32)
        self._cur_dev = torch.zeros((s,), dtype=torch.int64, device=dev)
        self._pos_dev = torch.zeros((s,), dtype=torch.int64, device=dev)
        self._active_dev = torch.zeros((s,), dtype=torch.bool, device=dev)
        self._temps_dev = torch.zeros((s,), dtype=torch.float32, device=dev)
        self._topks_dev = torch.zeros((s,), dtype=torch.int64, device=dev)
        self._topps_dev = torch.ones((s,), dtype=torch.float32, device=dev)
        self._reps_dev = torch.ones((s,), dtype=torch.float32, device=dev)
        self._press_dev = torch.zeros((s,), dtype=torch.float32, device=dev)
        self._freqs_dev = torch.zeros((s,), dtype=torch.float32, device=dev)
        # Per-slot emitted-token counts (penalty state), maintained on the
        # device by the decode steps and zeroed when a slot is patched.
        self._counts_dev = torch.zeros((s, self.sample_vocab),
                                       dtype=torch.int32, device=dev)
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(self.seed)
        self._dirty_slots: set[int] = set()
        # In-flight decode calls: (host copy of tokens [K, S], steps,
        # (slot, request) pairs running at dispatch).
        self._inflight: deque[tuple[_HostCopy, int,
                                    list[tuple[int, _Request]]]] = deque()
        self._pending_firsts: deque[tuple[_HostCopy, _Request, int]] = deque()

    # ---------------- public (asyncio side) ----------------

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self._stopped.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="torch-engine", daemon=True)
        self._thread.start()

    def shutdown(self, timeout_s: float = 30.0) -> None:
        if self._started:
            self._commands.put(("stop", None))
            self._stopped.wait(timeout=timeout_s)
            if self._thread is not None:
                self._thread.join(timeout=timeout_s)
            self._started = False

    def check_connection(self) -> bool:
        return self._started and self._thread is not None \
            and self._thread.is_alive()

    async def generate(self, request_id: str, session_id: str,
                       messages: list[dict], params: GenerationParams,
                       ) -> AsyncGenerator[dict, None]:
        """Stream events: {"type": "token", "text": ...} per delta, then a
        terminal {"type": "done"|"error"|"cancelled", ...}."""
        if not self.check_connection():
            raise LLMServiceError("Engine is not running (call start())",
                                  category=ErrorCategory.CONNECTION)
        prompt = self.tokenizer.apply_chat_template(messages)
        if len(prompt) >= self.usable_len:
            raise LLMServiceError(
                f"Prompt of {len(prompt)} tokens exceeds context window "
                f"{self.usable_len}", category=ErrorCategory.VALIDATION,
                recoverable=False)
        req = _Request(request_id=request_id, session_id=session_id,
                       prompt_tokens=prompt, params=params,
                       out_queue=asyncio.Queue(),
                       loop=asyncio.get_running_loop(),
                       detok=StreamDetokenizer(self.tokenizer))
        self._by_id[request_id] = req
        self._commands.put(("submit", req))
        terminal = False
        try:
            while True:
                event = await req.out_queue.get()
                terminal = event["type"] in ("done", "error", "cancelled")
                yield event
                if terminal:
                    return
        finally:
            if not terminal:
                # Caller abandoned the stream: free the slot.
                self.cancel(request_id)

    def cancel(self, request_id: str) -> bool:
        req = self._by_id.get(request_id)
        if req is None:
            return False
        req.cancelled = True
        self._commands.put(("cancel", request_id))
        return True

    def release_session(self, session_id: str) -> None:
        self._commands.put(("release", session_id))

    def get_model_info(self) -> dict:
        return {
            "kv_layout": "paged" if self.paged else "dense",
            "kv_quant": "int8" if self.kv_quant else "none",
            "kv_block_size": self.kv_block_size if self.paged else None,
            "model": self.cfg.name,
            "vocab_size": self.cfg.vocab_size,
            "num_layers": self.cfg.num_layers,
            "hidden_size": self.cfg.hidden_size,
            "parameters": self.cfg.param_count(),
            "context_window": self.usable_len,
            "decode_slots": self.num_slots,
            "dtype": str(self.dtype).replace("torch.", ""),
            "weight_quant": self.weight_quant,
            "device": str(self.device),
            "device_name": (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu"),
        }

    def get_stats(self) -> dict:
        out = {"slots": self.slots.stats(), "waiting": len(self._waiting),
               "prefilling": len(self._prefilling),
               "running": len(self._running),
               "tokens_generated": self.tokens_generated,
               "decode_calls": self.decode_calls,
               "decode_steps": self.decode_steps,
               "decode_host_s": self.decode_host_s}
        if self.paged:
            used = sum(min(s.kv_written, len(s.tokens))
                       for s in self.slots.slots)
            out["kv_blocks"] = self._kv_blocks.stats(used_tokens=used)
        return out

    # ---------------- engine thread ----------------

    def _run(self) -> None:
        log.info("engine thread started", model=self.cfg.name,
                 slots=self.num_slots, max_len=self.max_len,
                 device=str(self.device))
        reason = "engine shut down"
        try:
            while True:
                idle = not self._running and not self._inflight \
                    and not self._prefilling and not self._pending_firsts
                if not self._drain_commands(block=idle):
                    break
                if self._waiting:
                    self._admit()
                if self._prefilling:
                    self._advance_prefill()
                if self._pending_firsts:
                    self._drain_firsts(block=not self._inflight and not (
                        self._running and self._should_dispatch()))
                if self._running and self._should_dispatch():
                    self._dispatch_decode()
                    if len(self._inflight) >= self.pipeline_depth:
                        self._retire_oldest()
                elif self._inflight:
                    self._retire_oldest()
        except Exception as e:
            log.critical(f"engine thread crashed: {e}", exc_info=True)
            reason = f"engine crashed: {e}"
        finally:
            self._abort_all(reason)
            self._stopped.set()
            log.info("engine thread stopped")

    def _abort_all(self, reason: str) -> None:
        for req in list(self._by_id.values()):
            with self._term_lock:
                if req.finished:
                    continue
                req.finished = True
            self._emit(req, {"type": "error", "error": reason,
                             "code": "internal_error"})
        self._by_id.clear()
        self._waiting.clear()
        self._prefilling.clear()
        self._running.clear()
        self._inflight.clear()
        self._pending_firsts.clear()

    def _drain_commands(self, block: bool) -> bool:
        """Process queued commands. Returns False on stop."""
        while True:
            try:
                cmd, arg = self._commands.get(timeout=0.05 if block else 0.0)
            except queue.Empty:
                return True
            block = False
            if cmd == "stop":
                return False
            if cmd == "submit":
                self._waiting.append(arg)
            elif cmd == "cancel":
                req = self._by_id.get(arg)
                if req is not None:
                    req.cancelled = True
                    if req in self._waiting:
                        self._waiting.remove(req)
                        self._finish(req, "cancelled")
            elif cmd == "release":
                slot = self.slots.lookup(arg)
                if slot is not None and slot.active:
                    self._release_after.add(arg)
                else:
                    self.slots.release_session(arg)

    def _admit(self) -> None:
        """Move waiting requests, oldest first, into free slots. A request
        whose session is still generating waits without blocking others."""
        busy = {s.session_id for s in self.slots.slots
                if s.active and s.session_id is not None}
        keep: deque[_Request] = deque()
        while self._waiting:
            req = self._waiting.popleft()
            if req.finished:
                continue
            if req.cancelled:
                self._finish(req, "cancelled")
                continue
            if req.session_id in busy:
                keep.append(req)
                continue
            slot = self.slots.acquire(req.session_id)
            if slot is None:  # every slot is decoding
                keep.append(req)
                keep.extend(self._waiting)
                self._waiting.clear()
                break
            req.slot = slot
            req.admitted_at = time.monotonic()
            slot.active = True
            busy.add(req.session_id)
            prompt = req.prompt_tokens
            reused = self.slots.reuse_prefix(slot, prompt)
            if self.paged:
                # Blocks past the trusted rows (a diverged history) go back.
                self._kv_blocks.truncate(slot.index, slot.kv_written)
            todo = prompt[reused:]
            req.prefill_tokens = len(todo)
            if reused + len(todo) > self.usable_len:
                self._finish(req, "error", error=f"prompt ({len(prompt)} "
                             "tok) exceeds context")
                continue
            if self.paged and not self._paged_admissible(slot, req, reused,
                                                         len(todo)):
                continue  # shed with retry_after: the blocks do not fit
            self._prefilling.append(_PrefillState(req=req, slot=slot,
                                                  start=reused, todo=todo))
        self._waiting = keep

    def _advance_prefill(self) -> None:
        """Run ONE chunk of the oldest in-progress prefill."""
        keep: list[_PrefillState] = []
        for st in self._prefilling:
            if st.req.finished:
                continue
            if st.req.cancelled:
                self._finish(st.req, "cancelled")
                continue
            keep.append(st)
        self._prefilling = keep
        if not self._prefilling:
            return
        st = self._prefilling[0]
        req, slot = st.req, st.slot
        try:
            take = min(len(st.todo), self.prefill_chunk)
            bucket = next(b for b in _PREFILL_BUCKETS if b >= take)
            # A padded bucket must not run past the cache end.
            while st.start + bucket > self.max_len and take > 1:
                bucket //= 2
                take = min(take, bucket)
            if st.start + bucket > self.max_len:
                self._prefilling.pop(0)
                self._finish(req, "error",
                             error="KV cache exhausted during prefill")
                return
            if self.paged and not self._kv_blocks.ensure(
                    slot.index, st.start + bucket):
                # The padded bucket writes up to start + bucket: without
                # its blocks the padding would land in another slot's.
                self._prefilling.pop(0)
                self._paged_exhausted_finish(
                    req, "KV block pool exhausted during prefill")
                return
            chunk = st.todo[:take]
            st.last_logits = self._run_chunk_prefill(slot, chunk, st.start,
                                                     bucket)
            slot.tokens.extend(chunk)
            st.start += take
            slot.kv_written = st.start
            st.todo = st.todo[take:]
            if st.todo:
                return  # next chunk on a later iteration
            self._prefilling.pop(0)
            first = sample_tokens(
                st.last_logits[None, :self.sample_vocab], self._gen,
                self._dev_scalar(req.params.temperature, torch.float32),
                self._dev_scalar(req.params.top_k, torch.int64),
                self._dev_scalar(req.params.top_p, torch.float32),
                method=_SAMPLING)
            self._cur_dev[slot.index] = first[0]
            self._activate(req, slot)
            req.first_pending = True
            self._pending_firsts.append((_HostCopy(first), req, slot.index))
        except Exception as e:
            log.error(f"prefill failed for {req.request_id}: {e}",
                      exc_info=True)
            if self._prefilling and self._prefilling[0] is st:
                self._prefilling.pop(0)
            self._finish(req, "error", error=str(e))

    def _dev_scalar(self, value: float, dtype: torch.dtype) -> torch.Tensor:
        return torch.tensor([value], dtype=dtype, device=self.device)

    def _run_chunk_prefill(self, slot: Slot, chunk: list[int], start: int,
                           bucket: int) -> torch.Tensor:
        """One prompt chunk for one slot, written in place into the slot's
        cache rows; returns the last real token's logits [V]. Attention
        reads the slot's first ``ctx`` rows, a KV bucket covering the
        chunk (the rows past it are masked for every query).

        Paged: the slot's logical rows 0..ctx are gathered out of the pool
        into a dense [L, 1, ctx, ...] copy, the unchanged dense ``forward``
        runs over it, and the chunk's rows start..start+bucket scatter
        back through the table (their blocks were ensured by the caller).
        """
        ctx = next((b for b in _KV_BUCKETS
                    if b >= start + bucket and b <= self.max_len),
                   self.max_len)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :len(chunk)] = chunk
        tokens = torch.from_numpy(padded).to(self.device)
        positions = start + torch.arange(bucket, device=self.device)[None]
        if self.paged:
            read = self._paged_read_indices(slot.index, ctx)
            view = KVCache(*(None if x is None else x[:, read][:, None]
                             for x in self.cache))
        else:
            rows = slice(slot.index, slot.index + 1)
            view = KVCache(*(None if x is None else x[:, rows, :ctx]
                             for x in self.cache))
        logits, _ = forward(
            self.params, self.cfg, tokens, positions, view,
            torch.tensor([start], device=self.device), blockwise=True,
            logits_indices=torch.tensor([len(chunk) - 1],
                                        device=self.device))
        if self.paged:
            # ctx >= start + bucket (the caller keeps the bucket inside
            # max_len), so the chunk's pool rows are a slice of the read's.
            write = read[start:start + bucket]
            for pool, part in zip(self.cache, view):
                if pool is not None:
                    pool[:, write] = part[:, 0, start:start + bucket]
        return logits[0, 0]

    def _activate(self, req: _Request, slot: Slot) -> None:
        s = slot.index
        slot.active = True
        req.slot = slot
        self._running[s] = req
        self._positions[s] = len(slot.tokens)
        self._active_mask[s] = True
        self._temps[s] = req.params.temperature
        self._topks[s] = req.params.top_k
        self._topps[s] = req.params.top_p
        self._reps[s] = req.params.repeat_penalty
        self._press[s] = req.params.presence_penalty
        self._freqs[s] = req.params.frequency_penalty
        self._dirty_slots.add(s)

    def _drain_firsts(self, block: bool) -> None:
        while self._pending_firsts:
            copy, req, s = self._pending_firsts[0]
            if not block and not copy.done():
                return
            self._pending_firsts.popleft()
            tok = int(copy.result()[0])
            req.first_pending = False
            if req.finished or self._running.get(s) is not req:
                continue
            self._consume_token(req, tok)
            self._flush_emit(req)

    def _should_dispatch(self) -> bool:
        """Dispatch another K-step call only if some running request can
        still use tokens beyond what in-flight calls already promise it."""
        if self._pending_firsts and self._running and all(
                req.first_pending for req in self._running.values()):
            return False
        promised: dict[int, int] = {}
        for _, steps, snap in self._inflight:
            for _, req in snap:
                promised[id(req)] = promised.get(id(req), 0) + steps
        return any(
            req.params.max_tokens - req.generated
            - (1 if req.first_pending else 0) > promised.get(id(req), 0)
            for req in self._running.values())

    def _patch_slot_state(self) -> None:
        """Apply changed host mirrors onto the device decode state with one
        small upload; in-flight calls are ordered before it on the stream."""
        if not self._dirty_slots:
            return
        idx = sorted(self._dirty_slots)
        self._dirty_slots.clear()
        packed = np.stack([self._positions[idx], self._active_mask[idx],
                           self._temps[idx], self._topks[idx],
                           self._topps[idx], self._reps[idx],
                           self._press[idx], self._freqs[idx]],
                          axis=1).astype(np.float64)
        vals = torch.from_numpy(packed).to(self.device)
        ii = torch.as_tensor(idx, device=self.device)
        self._pos_dev[ii] = vals[:, 0].to(torch.int64)
        self._active_dev[ii] = vals[:, 1] > 0.5
        self._temps_dev[ii] = vals[:, 2].to(torch.float32)
        self._topks_dev[ii] = vals[:, 3].to(torch.int64)
        self._topps_dev[ii] = vals[:, 4].to(torch.float32)
        self._reps_dev[ii] = vals[:, 5].to(torch.float32)
        self._press_dev[ii] = vals[:, 6].to(torch.float32)
        self._freqs_dev[ii] = vals[:, 7].to(torch.float32)
        self._counts_dev[ii] = 0

    def _decode_steps(self, steps: int, kv_len: int,
                      table: torch.Tensor | None = None) -> torch.Tensor:
        """K decode steps on the device; returns the sampled tokens [K, S].
        Nothing here waits for the device. ``table`` [S, kv_len / bs] is
        the paged tier's block table."""
        toks = torch.empty((steps, self.num_slots), dtype=torch.int64,
                           device=self.device)
        cur, pos = self._cur_dev, self._pos_dev
        for k in range(steps):
            # A slot that finished mid-pipeline keeps "decoding" until the
            # host reconciles; keep it off the attention horizon.
            act = self._active_dev & (pos < kv_len)
            # Count the token being FED: every emitted token is counted
            # exactly once at sampling time.
            self._counts_dev.index_put_((self._rows, cur),
                                        act.to(torch.int32), accumulate=True)
            logits, _ = forward_decode(
                self.params, self.cfg, cur, pos, self.cache, act,
                attn_len=kv_len, block_table=table,
                block_size=self.kv_block_size if self.paged else 0)
            lg = apply_penalties(logits[:, :self.sample_vocab],
                                 self._counts_dev, self._reps_dev,
                                 self._press_dev, self._freqs_dev)
            cur = sample_tokens(lg, self._gen, self._temps_dev,
                                self._topks_dev, self._topps_dev,
                                method=_SAMPLING)
            pos = pos + act.to(pos.dtype)
            toks[k] = cur
        self._cur_dev, self._pos_dev = cur, pos
        return toks

    def _dispatch_decode(self) -> None:
        """Launch one K-step decode call; does not wait for results."""
        steps = (self.steps_burst if self._waiting or self._prefilling
                 or any(r.first_pending for r in self._running.values())
                 else self.steps_per_call)
        # Paged: blocks first, so that a shed's deactivation reaches this
        # very call through the patch below.
        if self.paged and not self._paged_prepare_decode(steps):
            return  # every running request was shed for blocks
        self._patch_slot_state()
        active = list(self._running)
        snapshot = list(self._running.items())
        # Device positions lead the host mirrors by the in-flight calls'
        # advances; size the KV bucket for where the device can be at the
        # end of this call.
        base = int(self._positions[active].max()) \
            + sum(n for _, n, _ in self._inflight)
        kv_len = next((b for b in _KV_BUCKETS
                       if b >= base + steps and b <= self.max_len),
                      self.max_len)
        t0 = time.perf_counter()
        table = (self._paged_table(kv_len // self.kv_block_size,
                                   list(range(self.num_slots)))
                 if self.paged else None)
        toks = self._decode_steps(steps, kv_len, table)
        self.decode_host_s += time.perf_counter() - t0
        self.decode_calls += 1
        self.decode_steps += steps
        self._inflight.append((_HostCopy(toks), steps, snapshot))

    def _retire_oldest(self) -> None:
        """Wait for the oldest in-flight call and consume its tokens."""
        copy, _, snapshot = self._inflight.popleft()
        if any(req.first_pending for _, req in snapshot):
            self._drain_firsts(block=True)
        res = copy.result()
        if self._pending_firsts:
            self._drain_firsts(block=False)
        for k in range(res.shape[0]):
            for s, req in snapshot:
                if req.finished or self._running.get(s) is not req:
                    continue  # ended earlier, or the slot was re-admitted
                self._positions[s] += 1
                self._consume_token(req, int(res[k, s]))
        for _, req in snapshot:
            self._flush_emit(req)

    def _consume_token(self, req: _Request, token_id: int) -> None:
        """Handle one newly sampled token for a request (host side)."""
        if req.cancelled:
            self._finish(req, "cancelled")
            return
        if token_id in self.tokenizer.eos_ids and not req.params.ignore_eos:
            self._finish(req, "stop")
            return
        slot = req.slot
        slot.tokens.append(token_id)
        req.generated += 1
        self.tokens_generated += 1
        if req.first_token_at is None:
            req.first_token_at = time.monotonic()
        delta = req.detok.push(token_id)
        if delta:
            self._stream_text(req, delta)
        if req.finished:
            return  # stop string hit inside _stream_text
        if req.generated >= req.params.max_tokens \
                or len(slot.tokens) >= self.usable_len:
            self._finish(req, "length")

    def _stream_text(self, req: _Request, delta: str) -> None:
        """Emit text, holding back any suffix that could start a stop seq."""
        stops = req.params.stop
        req.pending_text += delta
        if not stops:
            req.emit_buf += req.pending_text
            req.pending_text = ""
            return
        for stop in stops:
            idx = req.pending_text.find(stop)
            if idx >= 0:
                req.emit_buf += req.pending_text[:idx]
                req.pending_text = ""
                self._finish(req, "stop", suppress_flush=True)
                return
        hold = 0
        for stop in stops:
            for k in range(min(len(stop) - 1, len(req.pending_text)), 0, -1):
                if req.pending_text.endswith(stop[:k]):
                    hold = max(hold, k)
                    break
        cut = len(req.pending_text) - hold
        emit_now, req.pending_text = (req.pending_text[:cut],
                                      req.pending_text[cut:])
        req.emit_buf += emit_now

    def _finish(self, req: _Request, reason: str, error: str | None = None,
                suppress_flush: bool = False, code: str = "model_error",
                retry_after: float | None = None) -> None:
        with self._term_lock:
            if req.finished:
                return
            req.finished = True
        slot = req.slot
        if slot is not None:
            decoding = self._running.get(slot.index) is req
            slot.active = False
            slot.last_used = time.monotonic()
            self._running.pop(slot.index, None)
            self._active_mask[slot.index] = False
            self._temps[slot.index] = 0.0
            self._reps[slot.index] = 1.0
            self._press[slot.index] = 0.0
            self._freqs[slot.index] = 0.0
            if decoding:
                # KV rows exist only for FED tokens: a final token kept on
                # max_tokens/stop was sampled but never fed.
                slot.kv_written = min(slot.length,
                                      int(self._positions[slot.index]))
            self._positions[slot.index] = slot.length
            self._dirty_slots.add(slot.index)
            if self.paged and slot.session_id is not None:
                # Decode-growth slack past the trusted rows goes back. The
                # in-flight calls' late writes into those blocks are ahead
                # of any new owner's writes on the stream.
                self._kv_blocks.truncate(slot.index, slot.kv_written)
            sid = slot.session_id
            if sid is not None and sid in self._release_after:
                self._release_after.discard(sid)
                self.slots.release_session(sid)
        self._by_id.pop(req.request_id, None)

        if not suppress_flush and req.detok is not None \
                and reason != "cancelled":
            req.pending_text += req.detok.flush()
        if req.pending_text and reason != "cancelled":
            text = req.pending_text
            for stop in req.params.stop:
                idx = text.find(stop)
                if idx >= 0:
                    text = text[:idx]
                    reason = "stop"
            req.emit_buf += text
        req.pending_text = ""
        self._flush_emit(req)
        if error is not None:
            event = {"type": "error", "error": error, "code": code}
            if retry_after is not None:
                event["retry_after"] = retry_after
            self._emit(req, event)
            return
        duration = time.monotonic() - req.submitted_at
        if reason != "cancelled":
            self._service_ema_s = (duration if not self._service_ema_s else
                                   0.8 * self._service_ema_s + 0.2 * duration)
        ttft_ms = ((req.first_token_at or time.monotonic())
                   - req.submitted_at) * 1000
        self._emit(req, {
            "type": "cancelled" if reason == "cancelled" else "done",
            "finish_reason": reason,
            "stats": {
                "tokens_generated": req.generated,
                "processing_time_ms": duration * 1000,
                "tokens_per_second": (req.generated / duration
                                      if duration > 0 else 0.0),
                "ttft_ms": ttft_ms,
                "prompt_tokens": len(req.prompt_tokens),
                "prefill_tokens": req.prefill_tokens,
            },
        })

    def _flush_emit(self, req: _Request) -> None:
        """Send the text batched during one retirement as one token event."""
        if req.emit_buf:
            text, req.emit_buf = req.emit_buf, ""
            self._emit(req, {"type": "token", "text": text})

    def _emit(self, req: _Request, event: dict) -> None:
        try:
            req.loop.call_soon_threadsafe(req.out_queue.put_nowait, event)
        except RuntimeError:
            pass  # client loop already closed; drop

    # ---------------- paged KV tier ----------------
    # (KV_LAYOUT=paged; JAX engine.py :2826-3206. Engine thread only.)

    def _on_slot_unpin(self, slot: Slot) -> None:
        """SlotManager hook: a session leaving its slot (eviction or
        release) drops its whole block table."""
        if self.paged:
            self._kv_blocks.release(slot.index)

    def _paged_table(self, nb: int, slots: list[int]) -> torch.Tensor:
        """[len(slots), nb] int32 block table on the device. Unallocated
        entries stay 0: their rows sit beyond every slot's length, and
        masked decode writes go to the pool's sink block."""
        tbl = np.zeros((len(slots), nb), np.int32)
        for i, s in enumerate(slots):
            t = self._kv_blocks.table(s)[:nb]
            tbl[i, :len(t)] = t
        return torch.from_numpy(tbl).to(self.device)

    def _paged_read_indices(self, slot_index: int, rows: int) -> torch.Tensor:
        """Pool rows of one slot's logical positions 0..rows. Positions
        past the slot's table read pool row 0; the consumer masks them."""
        bs = self.kv_block_size
        table = self._paged_table(blocks_for(rows, bs), [slot_index])
        return paged_gather_indices(table, bs)[0, :rows].long()

    def _paged_reserve_tokens(self, req: _Request) -> int:
        """Decode growth the admission check must see free
        (KV_RESERVE_POLICY): 'fixed' the next KV_RESERVE_TOKENS, 'max_tokens'
        the request's whole budget, 'none' nothing (relies on the mid-decode
        shed)."""
        if self.kv_reserve_policy == "none":
            return 0
        if self.kv_reserve_policy == "max_tokens":
            return req.params.max_tokens
        return min(self.kv_reserve_tokens, req.params.max_tokens)

    def _paged_admissible(self, slot: Slot, req: _Request, reused: int,
                          todo: int) -> bool:
        """Admit iff the prompt's padded prefill horizon plus the reserve
        fits in free blocks; otherwise shed with retry_after."""
        bs = self.kv_block_size
        # The last chunk pads to a bucket: cover reused + the full chunks
        # + the last chunk's bucket.
        last = (todo % self.prefill_chunk
                or min(max(1, todo), self.prefill_chunk))
        pad = next((b for b in _PREFILL_BUCKETS if b >= last),
                   _PREFILL_BUCKETS[-1])
        need_tokens = min(self.max_len, reused + max(0, todo - last) + pad
                          + self._paged_reserve_tokens(req))
        need = blocks_for(need_tokens, bs) \
            - self._kv_blocks.slot_blocks(slot.index)
        if need <= self._kv_blocks.available():
            return True
        self._paged_exhausted_finish(
            req, f"KV block pool exhausted: prompt needs {need} more "
                 f"{bs}-token blocks ({self._kv_blocks.available()} free of "
                 f"{self.kv_pool_blocks})")
        return False

    def _paged_exhausted_finish(self, req: _Request, error: str) -> None:
        """End a request for want of blocks, as load shedding: roughly one
        service time must pass for a running generation to free its
        blocks."""
        self._finish(req, "error", error=error, code="kv_blocks_exhausted",
                     retry_after=round(max(0.5, self._service_ema_s), 2))

    def _paged_prepare_decode(self, steps: int) -> bool:
        """Ensure every running slot's blocks out to the write horizon of
        the next decode call: its host position plus the in-flight calls'
        steps plus this call's. On exhaustion, shed the most recently
        admitted request (its session is released, so its blocks free)
        and retry. Returns False when nothing is left to run."""
        lead = sum(n for _, n, _ in self._inflight) + steps
        while self._running:
            victim: _Request | None = None
            for s in self._running:
                horizon = min(self.max_len, int(self._positions[s]) + lead)
                if not self._kv_blocks.ensure(s, horizon):
                    victim = max(self._running.values(),
                                 key=lambda r: r.admitted_at)
                    break
            if victim is None:
                return True
            log.warning(f"KV block pool exhausted mid-decode; shedding "
                        f"{victim.request_id}")
            slot = victim.slot
            self._paged_exhausted_finish(
                victim, "KV block pool exhausted mid-decode: request shed "
                        "to free blocks")
            if slot is not None and slot.session_id is not None:
                self.slots.release_session(slot.session_id)
        return False
