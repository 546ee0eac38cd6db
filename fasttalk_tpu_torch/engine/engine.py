"""The serving engine: continuous batching over fixed decode slots.

Counterpart of the main-path subset of ``fasttalk_tpu/engine/engine.py``
(``TPUEngine``, :373), with its serving defaults:

- **One engine thread** owns every device interaction; asyncio callers
  talk to it through a command queue, and token deltas travel back with
  ``loop.call_soon_threadsafe`` onto per-request ``asyncio.Queue``s.
- **Admission through the scheduler** (scheduling/scheduler.py, JAX
  ``_admit`` :4074): priority classes with bulk aging, round-robin across
  sessions, queue deadlines enforced before a request touches the card, a
  bounded queue that sheds with ``retry_after`` (``AdmissionRejected``
  from ``generate``), and a graceful drain (``begin_drain``).
- **Prefill.** Sessions pin slots (engine/slots.py), so a follow-up turn
  prefills only the token delta after its resident prefix. A burst of
  admissions whose remaining prompts each fit one bucket prefills as one
  ``[group, bucket]`` forward per bucket with every first token sampled in
  one call (JAX ``_prefill_batched`` :4491, ``_prefill_group`` :4522);
  longer prompts prefill one chunk per loop iteration, so running
  sessions keep streaming.
- **Shared prefix** (``TPU_SHARED_PREFIX``): a fresh slot copies the
  longest prefix resident in another slot instead of prefilling it (JAX
  ``_stamp_prefix`` :2343), and a burst of fresh prompts prefills its
  longest prompt first and copies the shared rows to the others (JAX
  ``_prefill_batched_shared`` :4421).
- **K decode steps per call**, with the per-slot decode state kept on the
  device between steps and calls (engine/decode_steps.py). Up to
  ``pipeline_depth`` calls are enqueued on the CUDA stream before the host
  reads the oldest call's tokens (an asynchronous copy into pinned memory
  plus an event). Host mirrors of the slot state are reconciled at
  retirement and patched onto the device only when the slot set changes.
- **Speculative decoding** (``TPU_SPEC_DECODE``; JAX :2175-2340,
  :4814-5115): drafts by prompt lookup over each slot's device history,
  a verify block of draft + 1 positions, the longest sampled-equal prefix
  accepted. "ngram" makes every call speculative; "auto" takes a
  speculative call while the EMA of tokens per verify block clears the
  break-even and a plain (history-keeping) call otherwise, with a probe
  every 16 calls.
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
  in-flight calls); a prefill ensures ``start + bucket`` and runs as
  gather -> dense ``forward`` -> scatter of the chunk's rows. Blocks go
  back on session eviction and release, and past the trusted rows when a
  request finishes or a prompt diverges from the resident history. The
  shared prefix *aliases* the source's full blocks (refcounts) and copies
  only a partially shared tail block; a write never lands in a shared
  block: a slot's shared tail is copied on write (``_paged_sync_resident``)
  before anything is written past its trusted rows.
- **Radix prefix cache** (``KV_RADIX_ENABLED``, paged only; JAX :3003-3068,
  kvcache/radix.py): a finished or departing session donates its fully
  written blocks to a radix tree (allocator holds); a fresh admission
  aliases the longest cached block chain and prefills only the delta.
  Cached blocks no slot references are evicted under pool pressure before
  an admission sheds.
- **Host KV offload** (``KV_HOST_BUDGET_MB``; JAX :2477-2737,
  kvcache/offload.py): an evicted (or idle) session's kept rows are
  snapshotted on the device and copied into pinned host memory by the
  offload thread; a returning session restores them by one host-to-device
  copy (prestaged while it queues) and prefills only its delta, when the
  policy's measured copy cost beats the prefill. Admission order: resident
  prefix, radix match (unless a longer parked entry should restore), host
  restore, shared-prefix alias or copy.

- **Structured decoding** (``STRUCTURED_MODE``; JAX :651-690, :1497-1530,
  :3227-3465): a request's ``structured`` spec compiles to a token FSM off
  the engine thread (``FSMCompiler.compile_async``), is pinned into the
  union arena at admission and prefilled on the single-slot path, whose
  first token is sampled under the start state's mask. While any
  constrained slot runs, decode calls are the constrained plain calls
  (engine/decode_steps.py) and no speculative call is made; with none
  running the call is the unconstrained one. A forced chain of at least
  ``STRUCTURED_JF_MIN`` tokens is emitted by jump-forward: one prefill
  writes its rows and a masked sample restarts decoding.

- **Observability** (JAX :796-920, :1633-1727): the scheduler consults
  the SLO engine (``slo_gate``) and ``_finish`` feeds it one sample per
  request; the loop stamps a heartbeat each pass, ``progress_report`` and
  ``force_fail`` serve the stall watchdog; the tracer gets the JAX
  engine's span and step names (``queue_wait``, ``prefill``,
  ``decode_step``, ``decode``, ``detokenize``, ``engine_step``,
  ``engine_prefill``, ``engine_op``), and each step record's interval is
  the call's device span from CUDA events (observability/perf.py
  ``DeviceClock``), keyed by ``program_key`` for the perf ledger. A
  request with ``journey`` carries per-token stamps on its token events.

- **Lifecycle** (JAX :1034-1215): ``warmup(level)`` runs the serving
  shapes through the model before ``start()`` (building the kernels on the
  card), its writes going only into gathered copies or masked rows;
  ``shutdown(timeout_s)`` waits once for the thread and logs a stuck
  thread's stack; ``restart()`` recovers from an engine-thread crash: it
  waits for the card to finish what the dead thread queued (a sticky CUDA
  error fails it), keeps the host KV pool and the requests submitted in
  the crash race window, and rebuilds the slots, the paged allocator and
  radix tree, the KV cache (the old one released first) and the decode
  state before a new thread starts on the same command queue. The
  failpoint seams ``engine.loop.tick``, ``engine.prefill.dispatch``,
  ``engine.decode.dispatch`` and ``engine.retire.fetch`` are the JAX
  engine's (resilience/failpoints.py).

- **Fleet seams** (JAX :286-370, :1463-1479, :2531-2545, :2728-2823): the
  replica ``role`` (a ``prefill`` replica admits only ``prefill_only``
  requests), ``prefill_only`` (the prompt's rows are parked in the host
  pool and the request ends ``prefill_parked`` without a sample),
  ``set_trace_component``, and the migration of parked entries:
  ``export_parked_kv``, ``import_parked_kv`` (validated against this
  engine's geometry and tier, the rows copied into pinned tensors of its
  own pool) and ``parked_kv_info`` / ``drop_parked_kv``. An imported
  prefix is donated to the radix tree when it is restored.

- **Multi-rank serving** (``mesh``, parallel/; JAX :427-740, :1760-1764,
  :3602-3641): each rank holds its shards of the params (parallel/
  sharding.py) and of the dense KV cache (slots over "dp", sequence over
  "sp", KV heads over "tp") and the decode state of its own slots. Every
  device call is one replayable ``_dc_<kind>`` method whose arguments are
  host values (``decode``, ``spec``, ``batched_prefill``, ``prefill``,
  ``ring_prefill``, ``sample_place``, ``prefix_copy``, ``patch``,
  ``hist_patch``): ``_call`` publishes it to ``call_sink`` (an SPMD
  leader's ``CallBroadcaster``, parallel/spmd_serving.py) and runs it, and
  a follower runs the same methods in the same order, so every rank meets
  the same collectives. The host mirrors and every decision stay global
  and on the leader; a call maps the global slots it names onto the
  rank's own, and sampled tokens are gathered over "dp". The layer
  matmuls, the tied head and decode attention keep the hand-written
  kernels at the shard shapes; "sp" > 1 decodes over the whole cache
  length through ``decode_attention_sharded``, and a fresh prompt of at
  least one rank's KV shard prefills through ring attention. The JAX
  compatibility matrix holds with its messages: int4 weights, the int8 KV
  tier, the paged layout and ``STRUCTURED_MODE=on`` are refused on a
  mesh; shared prefixes and the host KV pool are turned off, and
  structured decoding under "auto" is unavailable.
"""

from __future__ import annotations

import asyncio
import math
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Any, AsyncGenerator

import numpy as np
import torch

from fasttalk_tpu_torch.engine.decode_steps import (DecodeState, FSMTables,
                                                    plain_steps, spec_steps,
                                                    unpack_mask)
from fasttalk_tpu_torch.engine.slots import Slot, SlotManager, _lcp
from fasttalk_tpu_torch.engine.tokenizer import StreamDetokenizer, Tokenizer
from fasttalk_tpu_torch.kvcache.blocks import BlockAllocator, blocks_for
from fasttalk_tpu_torch.kvcache.hostpool import (HostKVPool, entry_problem,
                                                 strip_device)
from fasttalk_tpu_torch.kvcache.offload import (KVOffloader, kv_bucket,
                                                kv_restore, kv_slice,
                                                paged_kv_restore,
                                                paged_kv_slice, upload)
from fasttalk_tpu_torch.kvcache.policy import RestorePolicy, kv_env_defaults
from fasttalk_tpu_torch.kvcache.radix import RadixTree
from fasttalk_tpu_torch.models.configs import ModelConfig
from fasttalk_tpu_torch.models.llama import (KVCache, forward, forward_ring,
                                             init_cache, init_paged_cache)
from fasttalk_tpu_torch.observability.events import get_events
from fasttalk_tpu_torch.observability.perf import (DeviceClock, get_perf,
                                                   program_key)
from fasttalk_tpu_torch.observability.slo import get_slo
from fasttalk_tpu_torch.observability.trace import get_tracer
from fasttalk_tpu_torch.ops.attention import paged_gather_indices
from fasttalk_tpu_torch.parallel import collectives
from fasttalk_tpu_torch.ops.kv_quant import granule_dim
from fasttalk_tpu_torch.ops.sampling import sample_tokens
from fasttalk_tpu_torch.quantization.int4 import (group_size_of, is_int4,
                                                  validate_group)
from fasttalk_tpu_torch.resilience import failpoints as _fp
from fasttalk_tpu_torch.scheduling.scheduler import RequestScheduler
from fasttalk_tpu_torch.structured.compiler import (FSMCompiler,
                                                    StructuredError,
                                                    validate_structured_spec)
from fasttalk_tpu_torch.structured.fsm import FSMTooLarge, TokenFSM
from fasttalk_tpu_torch.structured.runtime import (ArenaFull, FSMArena,
                                                   pack_mask_row)
from fasttalk_tpu_torch.utils.config import resolve_device
from fasttalk_tpu_torch.utils.errors import (ENGINE_SHED_CODES,
                                             AdmissionRejected, ErrorCategory,
                                             LLMServiceError)
from fasttalk_tpu_torch.utils.logger import get_logger
from fasttalk_tpu_torch.utils.metrics import get_metrics

log = get_logger("engine")

_KV_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 32768)
_PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)


def _tree_bytes(tree: Any) -> int:
    """Bytes of every tensor leaf of a params tree (dicts of tensors)."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _host_tensor(arr: Any) -> torch.Tensor:
    """A CPU torch tensor of a host row array: a torch tensor as it is, a
    numpy array through ``torch.from_numpy`` (bf16 rows of the JAX wire
    form arrive as ml_dtypes arrays; their bits are read through int16)."""
    if isinstance(arr, torch.Tensor):
        return arr.to("cpu")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _kv_bucket(need: int, max_len: int) -> int:
    """The smallest KV bucket holding ``need`` rows (``max_len`` past the
    last bucket that fits the cache)."""
    return next((b for b in _KV_BUCKETS if need <= b <= max_len), max_len)


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
    # Admission class and queue TTL (scheduling/scheduler.py):
    # "interactive" admits before "bulk"; deadline_s bounds the wait in the
    # admission queue (None = the scheduler's default).
    priority: str = "interactive"
    deadline_s: float | None = None
    # Text-completion mode (/v1/completions): the prompt is the joined
    # message content, BOS + its tokens, no chat template.
    raw_prompt: bool = False
    # Disaggregated prefill tier (router/disagg.py): prefill the prompt,
    # park its rows in the host pool and finish with reason
    # "prefill_parked": no first-token sample, no decode slot held.
    prefill_only: bool = False
    # Constrained decoding: {"kind": "json_object" | "json_schema" |
    # "regex" | "tool_call", ...}, compiled to a token FSM whose mask
    # applies at every sample. None = unconstrained.
    structured: Any = None
    # Per-token journey (observability/journey.py): token events carry the
    # retirement's fetch-wait start, fetch landing and enqueue stamps.
    journey: bool = False

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
        if self.priority not in ("interactive", "bulk"):
            raise ValueError(
                f"priority must be 'interactive' or 'bulk', "
                f"got {self.priority!r}")
        if self.deadline_s is not None:
            try:
                ok = math.isfinite(self.deadline_s) and self.deadline_s > 0
            except TypeError:
                ok = False
            if not ok:
                raise ValueError(
                    f"deadline_s must be a positive number, "
                    f"got {self.deadline_s!r}")
        if self.prefill_only and self.structured is not None:
            raise ValueError(
                "prefill_only is incompatible with structured output "
                "(the FSM samples the first token under its start-state "
                "mask; a prefill-tier request never samples)")
        if self.structured is not None:
            self.structured = validate_structured_spec(self.structured)
            if self.ignore_eos:
                raise ValueError(
                    "structured output is incompatible with "
                    "ignore_eos=true (the FSM decides where the "
                    "document ends)")
            if self.stop:
                raise ValueError(
                    "structured output is incompatible with stop "
                    "sequences: a stop string could truncate the "
                    "document mid-grammar and break the validity "
                    "guarantee")


def raw_prompt_text(messages: list[dict]) -> str:
    """The raw completion prompt of ``raw_prompt=True``: the joined
    message content (JAX ``raw_prompt_text``)."""
    return "".join(str(m.get("content") or "") for m in messages)


@dataclass(eq=False)
class _Request:
    request_id: str
    session_id: str
    prompt_tokens: list[int]
    params: GenerationParams
    out_queue: asyncio.Queue
    loop: asyncio.AbstractEventLoop
    submitted_at: float = field(default_factory=time.monotonic)
    admitted_at: float | None = None
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
    spec_accepted: int = 0     # accepted draft tokens
    spec_drafted: int = 0      # drafts offered to verification
    fsm: TokenFSM | None = None
    fsm_entry: Any = None      # structured/runtime._Entry while pinned
    fsm_state: int = 0         # local FSM state after the consumed tokens
    jump_tokens: int = 0       # tokens emitted by jump-forward
    # Observability stamps (JAX _Request :255-268): phase transitions,
    # the inter-token SLI and the watchdog's progress marks.
    decode_started_at: float | None = None  # activation (prefill done)
    last_token_at: float | None = None
    last_progress_at: float | None = None   # any forward progress
    detok_s: float = 0.0                    # cumulative detokenize time
    max_gap_ms: float = 0.0                 # worst inter-token gap
    stall_failed: bool = False              # terminated by the watchdog
    slo_recorded: bool = False              # sample fed to the SLO


@dataclass
class _PrefillState:
    req: _Request
    slot: Slot
    start: int
    todo: list[int]
    last_logits: Any = None
    t0: float = field(default_factory=time.monotonic)


# One admitted request bound for a batched prefill: (request, slot, rows
# already resident, the tokens to prefill).
_Item = tuple[_Request, Slot, int, list[int]]


class EngineBase:
    """The engine seam the serving layer depends on."""

    # Disaggregated-serving replica role (router/disagg.py): "mixed"
    # serves prefill and decode; "prefill" admits only prefill_only
    # handoff requests; "decode" is a placement hint. Set by the replica
    # handle (router/replica.py), read by the role gate in generate.
    role: str = "mixed"

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

    def warmup(self, level: str = "off") -> None:
        """Run the hot shapes before serving traffic (no-op by default;
        ``TorchEngine`` overrides)."""

    def begin_drain(self) -> None:
        """Graceful drain: refuse new submissions (with retry_after) while
        queued and running requests finish. No-op by default."""

    def pending_requests(self) -> int:
        """Requests still queued or running (drain progress)."""
        return 0

    def set_trace_component(self, component: str) -> None:
        """Tag this engine's spans with a fleet component name (e.g.
        ``inproc-0``), so in-proc replicas sharing the process tracer stay
        apart in stitched traces. No-op by default."""

    # ---- fleet KV migration (router/migrate.py). Engines without a host
    # pool answer None/False: the router then re-prefills.

    def export_parked_kv(self, session_id: str):
        """A session's parked entry (``ParkedKV``) without its
        device-staged buffers, or None. A peek: the source keeps the entry
        until the migration confirms and calls ``drop_parked_kv``."""
        return None

    def import_parked_kv(self, entry) -> bool:
        """Adopt a migrated entry into this engine's host pool. False
        when refused (geometry or tier mismatch, pool disabled, over
        budget); a refusal leaves the pool untouched."""
        return False

    def drop_parked_kv(self, session_id: str) -> bool:
        """Purge one session's parked entry (touches only the host pool,
        so it works on a replica whose engine thread is down)."""
        return False

    def parked_kv_info(self, session_id: str) -> tuple[int, int] | None:
        """(kept tokens, bytes) of a session's parked entry, or None."""
        return None


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


@dataclass
class _Call:
    """One in-flight decode call. ``promise``: tokens it is expected to
    give each request (sizes further dispatches); ``advance``: positions it
    is expected to advance (sizes a speculative call's KV bucket);
    ``max_advance``: the most it can advance (sizes a plain call's bucket,
    whose steps have no n_out column to drop a gated slot's token, and the
    paged tier's block horizon)."""

    copy: _HostCopy
    promise: float
    advance: int
    max_advance: int
    snapshot: list[tuple[int, _Request]]
    # The FSM tables a constrained call reads, held until it retires.
    tables: FSMTables | None = None
    # The call's device span (DeviceClock marks; None with tracing off),
    # its program key and KV horizon, for its step record.
    marks: tuple[Any, Any] | None = None
    program: str = ""
    kv_len: int = 0


class TorchEngine(EngineBase):
    """The port's engine. Owns params, KV cache, tokenizer, decode loop."""

    # Shared prefixes round down to this granule (JAX ``_STAMP_GRANULE``);
    # the slot scan's minimum share is the same 16 tokens.
    _STAMP_GRANULE = 16
    # Intra-burst sharing engages only from this common prefix on (JAX
    # ``_INTRA_SHARE_MIN``): below it the extra prefill wave costs more
    # than the rows it saves.
    _INTRA_SHARE_MIN = 64

    def __init__(self, model_cfg: ModelConfig, params: Any,
                 tokenizer: Tokenizer, *, device: str | torch.device | None = None,
                 num_slots: int = 16, max_len: int = 8192,
                 prefill_chunk: int = 512,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 context_window: int | None = None,
                 steps_per_call: int = 32, pipeline_depth: int = 2,
                 sampling_method: str = "fast",
                 spec_decode: str = "off", spec_draft_len: int = 7,
                 spec_breakeven: float = 1.45,
                 shared_prefix: bool = True,
                 queue_bound: int = 256,
                 default_deadline_s: float = 30.0,
                 bulk_aging_s: float = 5.0,
                 kv_quant: str = "none", kv_quant_granule: str = "token",
                 kv_layout: str = "dense", kv_block_size: int = 16,
                 kv_pool_blocks: int = 0, kv_reserve_policy: str = "fixed",
                 kv_reserve_tokens: int = 128,
                 kv_host_budget_mb: float | None = None,
                 kv_park_ttl_s: float | None = None,
                 kv_park_idle_s: float | None = None,
                 kv_restore_min_tokens: int | None = None,
                 kv_radix: bool = False,
                 kv_radix_min_blocks: int = 0,
                 kv_radix_evict_policy: str = "lru",
                 structured: str = "auto",
                 structured_max_states: int = 8192,
                 structured_state_budget: int = 16384,
                 structured_jf_min: int = 4,
                 structured_cache: int = 64,
                 structured_json_depth: int = 3,
                 mesh: Any = None):
        self.device = resolve_device(device)
        # The card the tensors live on: "cuda" without an index is the
        # constructing thread's current device, which the engine's own
        # threads must bind too.
        self._cuda_index = (
            (self.device.index if self.device.index is not None
             else torch.cuda.current_device())
            if self.device.type == "cuda" else None)
        self.cfg = model_cfg
        self.params = params
        self.tokenizer = tokenizer
        self.num_slots = num_slots
        # This rank's place in the mesh (JAX :427): its slots are
        # [_slot_lo, _slot_lo + local_slots) and its cache rows the
        # positions [_seq_lo, _seq_lo + max_len / sp). The model gets the
        # mesh only when there is more than one rank. ``call_sink`` is the
        # SPMD leader's broadcaster (JAX :787).
        self.mesh = mesh
        self.call_sink: Any = None
        self._dp, self._sp, self._tp = (
            (mesh.shape["dp"], mesh.shape["sp"], mesh.shape["tp"])
            if mesh is not None else (1, 1, 1))
        self._mesh_arg = mesh if mesh is not None and mesh.size > 1 \
            else None
        self._last_logits: torch.Tensor | None = None
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
        if sampling_method not in ("fast", "exact"):
            raise ValueError(f"sampling_method must be fast|exact, "
                             f"got {sampling_method!r}")
        self.sampling_method = sampling_method
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
            if mesh is not None:
                raise ValueError(
                    "WEIGHT_QUANT=int4 is single-device only in v1: the "
                    "partition rules for {'q4','s'} leaves exist "
                    "(parallel/sharding.py) but the sharded load/init "
                    "path is unvalidated — set TPU_TP_SIZE=TPU_DP_SIZE="
                    "TPU_SP_SIZE=1")
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
        if spec_decode not in ("off", "ngram", "auto"):
            raise ValueError(f"spec_decode must be off|ngram|auto, "
                             f"got {spec_decode!r}")
        self.kv_quant = kv_quant == "int8"
        if self.kv_quant and mesh is not None:
            raise ValueError(
                "KV_QUANT=int8 is single-device only: the per-row "
                "scale arrays do not shard with the kv axis yet")
        if self.kv_quant and spec_decode != "off":
            raise ValueError(
                "KV_QUANT=int8 is incompatible with speculative "
                "decoding (the spec carry does not thread the "
                "scale arrays through the verify block) — set "
                "TPU_SPEC_DECODE=off")
        self.kv_scale_granule = (granule_dim(kv_quant_granule,
                                             model_cfg.num_kv_heads)
                                 if self.kv_quant else 1)
        # Speculative decoding: "ngram" = every call speculative, "auto" =
        # per call from the measured acceptance EMA (tokens per verify
        # block) against the break-even, with a probe call every
        # ``_spec_probe_every`` plain calls; "off" = plain calls only.
        self.spec_mode = spec_decode
        self.spec_draft = max(1, spec_draft_len) if spec_decode != "off" \
            else 0
        self.spec_breakeven = spec_breakeven
        self._spec_probe_every = 16
        self._spec_probe_countdown = 1  # probe on the first call
        self._spec_ema = 1.0
        # Shared prefixes copy rows across slots, which a "dp"-sharded
        # slot axis does not hold on one rank (JAX :650).
        self.shared_prefix = shared_prefix and mesh is None
        self.paged = kv_layout == "paged"
        self.kv_block_size = int(kv_block_size)
        self._kv_blocks: BlockAllocator | None = None
        if self.paged:
            bs = self.kv_block_size
            if bs < 8 or bs > _KV_BUCKETS[0] or bs & (bs - 1):
                raise ValueError(f"KV_BLOCK_SIZE must be a power of two in "
                                 f"[8, {_KV_BUCKETS[0]}], got {bs}")
            if mesh is not None:
                raise ValueError(
                    "KV_LAYOUT=paged is single-device only: the block "
                    "pool and per-slot tables are host-orchestrated "
                    "per chip (no tp/dp/sp mesh yet)")
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
        if mesh is not None:
            from fasttalk_tpu_torch.parallel.sharding import (shard_params,
                                                              validate_mesh)

            validate_mesh(mesh, num_kv_heads=model_cfg.num_kv_heads,
                          num_heads=model_cfg.num_heads,
                          hidden=model_cfg.hidden_size,
                          intermediate=model_cfg.intermediate_size,
                          vocab=model_cfg.vocab_size,
                          num_slots=num_slots, max_len=self.max_len)
            if self._tp > 1 and self._params_full(params):
                # Whole params in: cut to this rank's shards (the factory
                # builds the shards directly).
                self.params = params = shard_params(params, mesh)
        self.local_slots = num_slots // self._dp
        self._slot_lo = (mesh.coords["dp"] * self.local_slots
                         if mesh is not None else 0)
        self._seq_lo = (mesh.coords["sp"] * (self.max_len // self._sp)
                        if mesh is not None else 0)
        self.cache: KVCache | None = self._make_cache()
        # Radix prefix cache (JAX :551-576): the tree owns pool blocks, so
        # it needs the paged layout (Config fails the same way).
        if kv_radix and not self.paged:
            raise ValueError(
                "KV_RADIX_ENABLED=true requires KV_LAYOUT=paged (the "
                "radix prefix cache holds device pool blocks; the "
                "dense layout has no block pool)")
        self._kv_radix: RadixTree | None = None
        if kv_radix:
            token_row_bytes = (2 * model_cfg.num_layers
                               * model_cfg.num_kv_heads * model_cfg.head_dim
                               * (1 if self.kv_quant else dtype.itemsize))
            self._kv_radix = RadixTree(
                self._kv_blocks,
                min_free_blocks=max(0, int(kv_radix_min_blocks)),
                evict_policy=kv_radix_evict_policy,
                token_bytes=token_row_bytes)
            self._kv_blocks.set_pressure(self._kv_radix.evict)
        # Host KV offload (JAX :725-750): unset knobs resolve from the KV_*
        # environment, as in the JAX engine (Config passes them).
        kvdef = kv_env_defaults()
        budget_mb = kvdef["budget_mb"] if kv_host_budget_mb is None \
            else kv_host_budget_mb
        if mesh is not None:
            # A sharded cache has no one host snapshot (JAX :728-733).
            budget_mb = 0.0
        self._kv_pool = HostKVPool(
            budget_mb=budget_mb,
            ttl_s=kvdef["ttl_s"] if kv_park_ttl_s is None else kv_park_ttl_s)
        self._kv_policy = RestorePolicy(
            min_tokens=int(kvdef["min_tokens"]
                           if kv_restore_min_tokens is None
                           else kv_restore_min_tokens))
        self._kv_offload = KVOffloader(self._kv_pool, self._kv_policy,
                                       self.device)
        self._kv_park_idle_s = kvdef["idle_s"] if kv_park_idle_s is None \
            else kv_park_idle_s
        self._kv_last_tick = 0.0
        self.kv_restore_failed = 0    # restores that fell back to prefill
        self.slots = SlotManager(num_slots, self.max_len,
                                 on_evict=self._park_on_evict,
                                 on_unpin=self._on_slot_unpin)
        # Structured decoding (JAX :651-690): unavailable on a mesh ("on"
        # then fails to build); "off" gives the reason every constrained
        # request is refused with.
        if structured not in ("auto", "on", "off"):
            raise ValueError(f"structured must be auto|on|off, "
                             f"got {structured!r}")
        reason: str | None = None
        if mesh is not None:
            reason = ("structured decoding is single-device only in "
                      "v1 (no tp/dp/sp mesh — per-slot FSM state is "
                      "not threaded through the sharded decode path)")
        if structured == "on" and reason is not None:
            raise ValueError(f"STRUCTURED_MODE=on: {reason}")
        if structured == "off":
            reason = "disabled (STRUCTURED_MODE=off)"
        self.structured_reason = reason
        self._st_jf_min = max(0, structured_jf_min)
        self._st_cfg = {"max_states": structured_max_states,
                        "state_budget": structured_state_budget,
                        "cache_size": structured_cache,
                        "json_depth": structured_json_depth}
        self._st_compiler: FSMCompiler | None = None   # lazy (asyncio side)
        self._st_compiler_lock = threading.Lock()
        self._st_arena: FSMArena | None = None         # lazy (engine thread)
        self._reset_decode_state()

        self._commands: queue.Queue = queue.Queue()
        # Admission control (scheduling/scheduler.py): submissions go into
        # the scheduler from the asyncio side, so a shed is synchronous;
        # the engine thread pops.
        self._slo = get_slo()
        self._sched = RequestScheduler(
            queue_bound=queue_bound, default_deadline_s=default_deadline_s,
            bulk_aging_s=bulk_aging_s, slots=num_slots,
            # SLO-aware shedding: while the interactive class page-burns,
            # incoming bulk sheds at the door (JAX :796-805).
            slo_gate=self._slo.should_shed)
        # Engine-loop heartbeat (observability/watchdog.py): stamped once
        # per loop pass; a stale stamp with pending work is a hung call.
        self._hb_mono: float | None = None
        self._prefilling: list[_PrefillState] = []
        self._running: dict[int, _Request] = {}
        self._by_id: dict[str, _Request] = {}
        self._release_after: set[str] = set()
        self._thread: threading.Thread | None = None
        self._stopped = threading.Event()
        self._started = False
        # start/shutdown/restart serialise here; a shut-down engine is never
        # restarted (JAX :822-829).
        self._lifecycle_lock = threading.Lock()
        self._closed = False
        self._events = get_events()
        self._term_lock = threading.Lock()
        self.tokens_generated = 0
        self.decode_calls = 0
        self.decode_steps = 0
        self.decode_host_s = 0.0   # host time spent enqueueing decode calls
        self.spec_calls = 0        # of the decode calls, speculative ones
        self.spec_steps = 0
        self.spec_host_s = 0.0
        self.spec_accepted = 0     # accepted drafts over retired blocks
        self.spec_drafted = 0
        self.spec_blocks = 0       # verify blocks that emitted tokens
        # Speculative calls whose batch held a constrained slot: the verify
        # block is not masked, so this must stay 0.
        self.spec_constrained_calls = 0
        self.batched_prefill_calls = 0
        self.batched_prefill_rows = 0
        self.ring_prefill_calls = 0
        self.prefix_tokens_shared = 0
        self.structured_calls = 0  # of the decode calls, constrained ones
        self.structured_steps = 0
        self.structured_host_s = 0.0
        self.structured_jump_tokens = 0
        m = get_metrics()
        self._m_tokens = m.counter("engine_tokens_generated_total",
                                   "tokens generated by the engine")
        self._m_requests = m.counter("engine_requests_total",
                                     "generation requests accepted")
        self._m_ttft = m.histogram("engine_ttft_ms", "time to first token")
        self._m_step = m.histogram(
            "engine_decode_wait_ms",
            "host blocking wait per retired K-step decode call "
            "(near zero when retirement overlaps the next call)",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1000, 4000))
        self._m_prefill = m.histogram(
            "engine_prefill_ms", "prefill wall time per request",
            buckets=(4, 16, 64, 256, 1000, 4000, 16000, 60000))
        self._m_active = m.gauge("engine_active_slots", "slots decoding")
        self._m_queue = m.gauge("engine_queue_depth", "requests waiting")
        self._m_queue_wait = m.histogram(
            "queue_wait_ms", "wait from request submit to slot admission")
        self._m_prefill_req = m.histogram(
            "prefill_ms",
            "prefill wall time per request, admission to first-token "
            "sample", buckets=(4, 16, 64, 256, 1000, 4000, 16000, 60000))
        self._m_intertok = m.histogram(
            "inter_token_ms",
            "gap between consecutive tokens of one request",
            buckets=(0.5, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1000,
                     4000))
        self._m_prefix = m.counter("engine_prefix_tokens_reused_total",
                                   "prompt tokens served from resident KV")
        self._m_shared = m.counter(
            "engine_shared_prefix_tokens_total",
            "prompt tokens served by cross-slot KV copy instead of "
            "prefill")
        self._m_spec = m.histogram(
            "engine_spec_tokens_per_verify",
            "tokens emitted per speculative verify block (accepted "
            "drafts + 1); 1 means no draft accepted",
            buckets=tuple(range(1, max(2, self.spec_draft + 2))))
        self._m_st_requests = m.counter(
            "structured_requests_total",
            "constrained (structured-output) generations accepted")
        self._m_st_jump = m.counter(
            "structured_jump_forward_tokens_total",
            "forced tokens emitted by jump-forward without decode "
            "steps")
        self._tracer = get_tracer()
        # Journey stamps of the current retirement: the blocking fetch's
        # start and landing (JAX :890-895).
        self._j_wait0 = 0.0
        self._j_fetched = 0.0
        # Program-key attributes of cache-touching calls (JAX :503-509).
        self._kvq_attrs: dict[str, Any] = (
            {"kv_quant": "int8"} if self.kv_quant else {})
        if self.weight_quant == "int4":
            self._kvq_attrs["weight_quant"] = "int4"
        # The perf ledger's byte and FLOP facts (JAX :896-929), at the
        # resident element sizes: bytes one decode step reads per (slot,
        # position) row across all layers (int8 rows + f32 scales on the
        # int8 tier), and the weight bytes a step streams (an untied
        # embedding is only gathered, not streamed).
        kv_elt = 1 if self.kv_quant else dtype.itemsize
        self._kv_row_bytes = 2 * model_cfg.num_layers * (
            model_cfg.num_kv_heads * model_cfg.head_dim * kv_elt
            + (self.kv_scale_granule * 4 if self.kv_quant else 0))
        self._weight_bytes_per_step = _tree_bytes(params)
        if "lm_head" in params:
            self._weight_bytes_per_step -= _tree_bytes(params["embed"])
        self._perf = get_perf()
        self._perf.bind_model(
            model_cfg, num_slots, str(dtype).replace("torch.", ""),
            kv_quant=kv_quant, kv_row_bytes=self._kv_row_bytes,
            weight_quant=self.weight_quant,
            weight_bytes_per_step=self._weight_bytes_per_step,
            attention_kernel=("decode_attend_paged" if self.paged
                              else "decode_attend"),
            device=self.device)
        # Device spans of the step records (CUDA events on the card), and
        # the prefill/op records whose end mark the stream has not passed
        # yet: (name, start mark, end mark, attrs), in stream order.
        self._devclock = DeviceClock(self.device)
        self._dev_pending: deque[tuple[str, Any, Any, dict]] = deque()

    def _params_full(self, params: Any) -> bool:
        """Whether ``params`` hold whole leaves (wq's output axis is the
        model's q_dim) rather than a "tp" shard."""
        wq = params["layers"]["wq"]
        wq = wq["q"] if isinstance(wq, dict) else wq
        return wq.shape[-1] == self.cfg.q_dim

    def _make_cache(self) -> KVCache:
        """A zeroed KV cache: the block pool (paged) or one region per slot
        (dense; on a mesh this rank's shard of it)."""
        if self.mesh is not None:
            from fasttalk_tpu_torch.parallel.sharding import \
                cache_local_shape

            _, slots, rows, heads, _ = cache_local_shape(
                self.cfg.num_layers, self.num_slots, self.max_len,
                self.cfg.num_kv_heads, self.cfg.head_dim, self.mesh)
            return init_cache(replace(self.cfg, num_kv_heads=heads), slots,
                              rows, self.dtype, self.device)
        if self.paged:
            return init_paged_cache(
                self.cfg, self.kv_pool_blocks, self.kv_block_size, self.dtype,
                self.device, quantized=self.kv_quant,
                scale_granule=self.kv_scale_granule)
        return init_cache(self.cfg, self.num_slots, self.max_len, self.dtype,
                          self.device, quantized=self.kv_quant,
                          scale_granule=self.kv_scale_granule)

    def _reset_decode_state(self) -> None:
        s = self.num_slots
        self._positions = np.zeros((s,), np.int64)
        self._active_mask = np.zeros((s,), bool)
        self._temps = np.zeros((s,), np.float32)
        self._topks = np.zeros((s,), np.int64)
        self._topps = np.ones((s,), np.float32)
        self._reps = np.ones((s,), np.float32)
        self._press = np.zeros((s,), np.float32)
        self._freqs = np.zeros((s,), np.float32)
        # The device side: current tokens, positions, sampling parameters,
        # penalty counts (zeroed when a slot is patched), the generator and
        # (speculative decoding) the draft history. On a mesh it holds this
        # rank's slots, and each "dp" group samples from its own seed.
        dp_index = self.mesh.coords["dp"] if self.mesh is not None else 0
        self._dev = DecodeState.zeros(
            self.local_slots, self.sample_vocab,
            self.max_len if self.spec_draft else 0, self.device,
            self.seed + 1_000_003 * dp_index)
        self._dirty_slots: set[int] = set()
        # slot -> its tokens, to upload into the draft history.
        self._dirty_history: dict[int, list[int]] = {}
        self._inflight: deque[_Call] = deque()
        # First tokens awaiting their host copy: (copy, [(row in the copy,
        # slot, request)]).
        self._pending_firsts: deque[
            tuple[_HostCopy, list[tuple[int, int, _Request]]]] = deque()
        # Structured decoding: each slot's row of the arena's class table
        # (host mirror; 0 = FREE) and its device copy, the union tables on
        # the device, the slots whose device FSM state must be patched from
        # the host mirrors (finish -> FREE, arena repack), and the requests
        # waiting for a jump-forward.
        self._st_sel = np.zeros((s,), np.int64)
        self._st_sel_dev: torch.Tensor | None = None
        self._st_tables: FSMTables | None = None
        self._st_dirty: set[int] = set()
        self._st_jf_pending: set[str] = set()
        if self._st_arena is not None:
            self._st_arena.dirty = True   # fresh state: upload the tables

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
        """Stop the engine thread, waiting up to ``timeout_s`` for it once;
        a thread still stuck then is reported with its stack and left
        behind (JAX :1044-1082)."""
        with self._lifecycle_lock:
            self._closed = True
            if self._started:
                self._commands.put(("stop", None))
                deadline = time.monotonic() + timeout_s
                if self._stopped.wait(timeout=timeout_s):
                    # _stopped is the thread's last act: the join is short.
                    if self._thread is not None:
                        self._thread.join(
                            timeout=max(0.0, deadline - time.monotonic()))
                else:
                    self._log_stuck_thread(timeout_s)
                self._started = False
                if self._st_compiler is not None:
                    self._st_compiler.shutdown()
            self._kv_offload.shutdown()

    def _log_stuck_thread(self, timeout_s: float) -> None:
        """The thread did not stop in time: log where it is stuck and emit
        a critical ``engine_shutdown_stuck`` event carrying the stack."""
        import sys
        import traceback

        thread = self._thread
        stack = ""
        if thread is not None and thread.ident is not None:
            frame = sys._current_frames().get(thread.ident)
            if frame is not None:
                stack = "".join(traceback.format_stack(frame))
        log.critical(
            f"engine thread failed to stop within {timeout_s:.0f}s; "
            f"leaking it. Stuck at:\n{stack or '<thread already gone>'}")
        self._events.emit("engine_shutdown_stuck", severity="critical",
                          timeout_s=timeout_s,
                          stack=stack[-2000:] if stack else "")

    def restart(self) -> bool:
        """Recover from an engine-thread crash (JAX :1084-1206): rebuild
        the device state and start a new thread on the same command queue,
        so requests submitted during the outage are served. Session
        residency on the card is dropped (a session's next turn restores
        its parked host rows or prefills); the host KV pool is kept.

        The card first finishes everything the dead thread queued (decode
        calls, first-token and KV snapshot copies, the offload side
        stream's uploads), so nothing still reads the cache and decode
        state that are dropped next. A CUDA error there is sticky (the
        context is lost): the restart fails and the supervisor's budget
        runs out, never carrying on on the CPU. Returns False after
        ``shutdown``, while the old thread is still alive, or on failure.
        """
        with self._lifecycle_lock:
            if self._closed:
                return False  # shutdown won; never resurrect past it
            if self.call_sink is not None or self._mesh_arg is not None:
                # Restart is this rank's device-state surgery and is not
                # replicated; multi-rank recovery is a cluster restart
                # (parallel/spmd_serving.py; JAX :1098-1104).
                log.error("engine restart unsupported in multi-host "
                          "SPMD serving mode")
                return False
            if self.check_connection():
                return True
            if self._thread is not None and self._thread.is_alive():
                return False  # still tearing down; try again later
            log.warning("engine restart: rebuilding device decode state")
            self._events.emit("engine_restart", severity="critical",
                              parked_sessions=len(self._kv_pool))
            try:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            except Exception as e:
                log.critical(f"engine restart failed: the device did not "
                             f"finish the crashed thread's work: {e}")
                return False
            # Requests _abort_all ended must not be admitted; ones submitted
            # after its sweep (the crash race window) stay queued and
            # registered, pruned in place since generate() may register
            # concurrently.
            self._sched.remove_finished()
            self._prefilling.clear()
            self._running.clear()
            self._release_after.clear()
            for rid in [rid for rid, r in self._by_id.items()
                        if r.finished]:
                self._by_id.pop(rid, None)
            self.slots = SlotManager(self.num_slots, self.max_len,
                                     on_evict=self._park_on_evict,
                                     on_unpin=self._on_slot_unpin)
            if self.paged:
                # Every session re-prefills, so no table survives; the tree
                # is rebuilt empty over the fresh pool.
                self._kv_blocks = BlockAllocator(
                    self.kv_pool_blocks, self.kv_block_size, self.num_slots)
                if self._kv_radix is not None:
                    self._kv_radix = RadixTree(
                        self._kv_blocks,
                        min_free_blocks=self._kv_radix.min_free_blocks,
                        evict_policy=self._kv_radix.evict_policy,
                        token_bytes=self._kv_radix.token_bytes)
                    self._kv_blocks.set_pressure(self._kv_radix.evict)
            # Release the old cache and everything the dead thread's calls
            # held before allocating anew: holding both would double the
            # KV cache on the card. Its CUDA events are dropped unread. The
            # rows are freed outright, whoever still holds the tensors (a
            # frame of the dead thread kept alive elsewhere): after the
            # sync above nothing reads them again.
            old, self.cache = self.cache, None
            for part in old or ():
                if part is not None:
                    part.untyped_storage().resize_(0)
            del old
            self._inflight.clear()
            self._pending_firsts.clear()
            self._dev_pending.clear()
            self._dev = None
            try:
                self.cache = self._make_cache()
                self._reset_decode_state()
            except Exception as e:
                log.critical(f"engine restart failed: {e}", exc_info=True)
                return False
            self._started = False
            self.start()
            return self.check_connection()

    def warmup(self, level: str = "fast") -> None:
        """Run the serving shapes through the model before ``start()``, in
        the caller's thread, so the first request pays neither the kernel
        builds nor the first launches (JAX :1208-1450).

        ``fast``: the decode calls of the first KV bucket (every step
        count the engine dispatches, plain and, with speculative decoding,
        the verify block) and the prefill of the common prompt bucket, the
        largest bucket within the chunk and the chunk's own bucket, for one
        row and for ``num_slots`` rows. ``full``: every KV bucket up to the
        cache length and every prefill bucket. The decode calls run with
        every slot inactive, so their cache and history writes are masked;
        the prefills run over gathered copies of cache rows, so they write
        nothing the engine reads. The decode state is reset afterwards. A
        kernel that fails to build raises here."""
        if level in ("off", "", "none"):
            return
        if level not in ("fast", "full"):
            raise ValueError(f"warmup level must be off|fast|full, "
                             f"got {level!r}")
        if self._started:
            raise RuntimeError("warmup() must be called before start()")
        if self._mesh_arg is not None:
            # Warmup calls are not replicated: a follower would never meet
            # their collectives (the JAX launcher forces warmup off).
            log.info("warmup skipped on a multi-rank mesh")
            return
        t0 = time.monotonic()
        kv_buckets = [b for b in _KV_BUCKETS if b <= self.max_len] \
            or [self.max_len]
        chunk_bucket = next((b for b in _PREFILL_BUCKETS
                             if b >= self.prefill_chunk), _PREFILL_BUCKETS[-1])
        pbuckets = [b for b in _PREFILL_BUCKETS if b <= self.prefill_chunk] \
            or [_PREFILL_BUCKETS[0]]
        if level == "fast":
            common = 64 if 64 in pbuckets else pbuckets[0]
            pbuckets = sorted({common, pbuckets[-1], chunk_bucket})
            kv_buckets = kv_buckets[:1]
        kw = dict(sample_vocab=self.sample_vocab, method=self.sampling_method,
                  block_size=self.kv_block_size if self.paged else 0)
        toks = None
        for kv_len in kv_buckets:
            table = self._decode_table(kv_len)
            for steps in sorted({self.steps_burst, self.steps_per_call}):
                toks = plain_steps(self.params, self.cfg, self.cache,
                                   self._dev, steps, kv_len, table=table,
                                   **kw)
                if self.spec_draft:
                    spec_steps(self.params, self.cfg, self.cache, self._dev,
                               steps, kv_len, self.spec_draft, table=table,
                               **kw)
        if toks is not None:
            _HostCopy(toks).result()   # the pinned copy a retirement makes
        for bucket in pbuckets:
            ctx = _kv_bucket(bucket, self.max_len)
            for group in sorted({1, self.num_slots}):
                self._warm_prefill(group, bucket, ctx)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._reset_decode_state()
        log.info(f"warmup ({level}) done in {time.monotonic() - t0:.1f}s: "
                 f"decode KV buckets {kv_buckets}, prefill buckets "
                 f"{pbuckets}")

    def _warm_prefill(self, group: int, bucket: int, ctx: int) -> None:
        """One ``[group, bucket]`` prefill and its first-token sample over a
        gathered copy of slot 0's first ``ctx`` rows (the batched path's
        shapes; one row is the chunked path's): the forward writes only
        into the copy."""
        dev = self.device
        rows = torch.zeros((group, ctx), dtype=torch.long, device=dev)
        if self.paged:
            view = KVCache(*(None if x is None else x[:, rows]
                             for x in self.cache))
        else:
            view = KVCache(*(None if x is None else x[:, rows[:, 0], :ctx]
                             for x in self.cache))
        positions = torch.arange(bucket, device=dev)[None].expand(group, -1)
        logits, _ = forward(
            self.params, self.cfg,
            torch.zeros((group, bucket), dtype=torch.int64, device=dev),
            positions, view, torch.zeros((group,), dtype=torch.int64,
                                         device=dev),
            blockwise=True,
            logits_indices=torch.full((group,), bucket - 1, device=dev))
        firsts = sample_tokens(
            logits[:, 0, :self.sample_vocab], self._dev.gen,
            torch.ones((group,), dtype=torch.float32, device=dev),
            torch.full((group,), 40, dtype=torch.int64, device=dev),
            torch.full((group,), 0.9, dtype=torch.float32, device=dev),
            method=self.sampling_method)
        _HostCopy(firsts).result()

    def check_connection(self) -> bool:
        return self._started and self._thread is not None \
            and self._thread.is_alive()

    async def generate(self, request_id: str, session_id: str,
                       messages: list[dict], params: GenerationParams,
                       ) -> AsyncGenerator[dict, None]:
        """Stream events: {"type": "token", "text": ...} per delta, then a
        terminal {"type": "done"|"error"|"cancelled", ...}. A shed at
        admission raises ``AdmissionRejected`` (with ``retry_after``)
        before any event."""
        if not self.check_connection():
            raise LLMServiceError("Engine is not running (call start())",
                                  category=ErrorCategory.CONNECTION)
        if self.role == "prefill" and not params.prefill_only:
            # Disaggregated prefill tier: a decode stream admitted here
            # would bring back the interference the role split removes
            # (JAX :1463-1473).
            raise LLMServiceError(
                "replica role is 'prefill': decode streams are "
                "rejected (only prefill_only handoff requests admit)",
                category=ErrorCategory.VALIDATION, recoverable=False)
        if params.prefill_only and not self._kv_pool.enabled:
            raise LLMServiceError(
                "prefill_only requires the host KV pool "
                "(KV_HOST_BUDGET_MB > 0): the finished prefill is "
                "parked there for the decode-tier handoff",
                category=ErrorCategory.VALIDATION, recoverable=False)
        if params.raw_prompt:
            prompt = self.tokenizer.encode_prompt(raw_prompt_text(messages))
        else:
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
        if params.structured is not None:
            # Compiled (or a cache hit) off the engine thread and off this
            # event loop before submission; compat and compile failures
            # are client-shape errors (400 / invalid_config).
            if self.structured_reason is not None:
                raise LLMServiceError(
                    f"structured output unavailable: "
                    f"{self.structured_reason}",
                    category=ErrorCategory.VALIDATION, recoverable=False)
            try:
                req.fsm = await self._get_st_compiler().compile_async(
                    params.structured)
            except (StructuredError, FSMTooLarge) as e:
                raise LLMServiceError(
                    str(e), category=ErrorCategory.VALIDATION,
                    recoverable=False) from e
            req.fsm_state = req.fsm.start
            self._m_st_requests.inc()
            if self._tracer.enabled:
                self._tracer.add_span(
                    request_id, "fsm_compile", req.submitted_at,
                    time.monotonic(),
                    kind=params.structured.get("kind"),
                    states=req.fsm.n_states, classes=req.fsm.n_classes)
        self._m_requests.inc()
        # The serving layer starts the trace first (it owns the finish);
        # engine-seam callers own it here (JAX :1533-1540).
        trace_owned = self._tracer.start(request_id, session_id)
        if self._tracer.enabled:
            self._tracer.set_phase(request_id, "queued",
                                   priority=params.priority)
        # Registered before the submit, so an immediate cancel() cannot
        # race the engine thread's command drain.
        self._by_id[request_id] = req
        try:
            # A parked entry's restore shortens the wait estimate by what
            # it saves; a paged pool that cannot hold the prompt now makes
            # it about one service time longer (JAX :1545-1556).
            self._sched.submit(request_id, session_id,
                               priority=params.priority,
                               deadline_s=params.deadline_s, payload=req,
                               wait_discount_s=self._kv_wait_discount(
                                   session_id, prompt)
                               - self._paged_wait_penalty(len(prompt)))
        except AdmissionRejected:
            self._by_id.pop(request_id, None)
            req.finished = True
            self._slo.record_shed(params.priority)
            if self._tracer.enabled:
                self._tracer.event(request_id, "shed")
            if trace_owned:
                self._tracer.finish(request_id)
            raise
        if self._kv_pool.enabled:
            # Best-effort: upload this session's parked rows while the
            # request waits in the queue (JAX :1567-1572).
            self._kv_offload.prestage(session_id)
        self._commands.put(("kick", None))  # wake the engine thread
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
            if trace_owned:
                self._tracer.finish(request_id)

    def cancel(self, request_id: str) -> bool:
        req = self._by_id.get(request_id)
        if req is None:
            return False
        req.cancelled = True
        self._commands.put(("cancel", request_id))
        return True

    def release_session(self, session_id: str) -> None:
        self._commands.put(("release", session_id))

    def begin_drain(self) -> None:
        """Stop admitting new submissions (they shed with retry_after);
        queued and running requests run to completion."""
        self._sched.begin_drain()
        if self._started:
            self._commands.put(("kick", None))

    def pending_requests(self) -> int:
        """Requests not yet terminal (queued, prefilling or running)."""
        return len(self._by_id)

    def set_trace_component(self, component: str) -> None:
        """In-proc replicas of a fleet share one process tracer: the
        component attr keeps each replica's spans apart in a stitched
        trace (JAX :1615-1620)."""
        self._tracer = get_tracer().scoped(component)

    # ---------------- watchdog surfaces (observability/watchdog.py) ----

    def heartbeat_age(self, now: float | None = None) -> float | None:
        """Seconds since the engine loop last began a pass (None before
        the first). A large age with pending work is a blocked call."""
        hb = self._hb_mono
        if hb is None:
            return None
        return (time.monotonic() if now is None else now) - hb

    def progress_report(self, now: float | None = None,
                        ) -> list[dict[str, Any]]:
        """Admitted, unfinished requests with how long each has gone
        without forward progress (a token, a prefill chunk, activation).
        Queued requests are the scheduler's deadline sweep's."""
        now = time.monotonic() if now is None else now
        out: list[dict[str, Any]] = []
        for req in list(self._by_id.values()):
            if req.finished or req.admitted_at is None:
                continue
            last = max(filter(None, (req.last_token_at,
                                     req.last_progress_at,
                                     req.admitted_at)))
            out.append({
                "request_id": req.request_id,
                "session_id": req.session_id,
                "phase": "decode" if req.decode_started_at is not None
                else "prefill",
                "no_progress_s": round(now - last, 3),
            })
        return out

    def force_fail(self, request_id: str, error: str,
                   code: str = "stalled") -> bool:
        """Watchdog termination: the terminal error event goes out now,
        from outside the engine thread (which may be hung). The request
        is marked cancelled and a cancel queued, so a live engine thread
        frees the slot through ``_finish`` (whose late event is dropped
        by the closed stream). The check-and-set against ``_finish`` is
        atomic under the terminal lock (JAX :1667-1727)."""
        req = self._by_id.get(request_id)
        if req is None:
            return False
        with self._term_lock:
            if req.finished or req.stall_failed:
                return False
            req.stall_failed = True
            req.cancelled = True
        self._record_slo(req, ok=False)
        self._emit(req, {"type": "error", "error": error, "code": code})
        self._commands.put(("cancel", request_id))
        return True

    def _record_slo(self, req: _Request, ok: bool) -> None:
        """Feed one finished request into the SLO engine, once (the
        watchdog's force_fail and _finish can both reach a request)."""
        with self._term_lock:
            if req.slo_recorded:
                return
            req.slo_recorded = True
        ttft_ms = ((req.first_token_at - req.submitted_at) * 1000.0
                   if req.first_token_at is not None else None)
        qw_ms = ((req.admitted_at - req.submitted_at) * 1000.0
                 if req.admitted_at is not None else None)
        # A single-token reply has no inter-token gap to judge.
        gap_ms = req.max_gap_ms if req.generated >= 2 else None
        self._slo.record_request(req.params.priority, ok=ok,
                                 ttft_ms=ttft_ms, queue_wait_ms=qw_ms,
                                 max_gap_ms=gap_ms)

    # ---------------- perf ledger records ----------------

    def _decode_program(self, kv_len: int, steps: int, st_on: bool) -> str:
        return program_key(
            "decode", kv_len=kv_len, steps=steps,
            **({"structured": True} if st_on else {}),
            **self._kvq_attrs,
            **({"kv_layout": "paged"} if self.paged else {}))

    def _prefill_program(self, start: int, bucket: int) -> str:
        if self.paged:
            ctx = _kv_bucket(start + bucket, self.max_len)
            return program_key("prefill", chunk=bucket, ctx=ctx,
                               kv_layout="paged", **self._kvq_attrs)
        return program_key("prefill", chunk=bucket, **self._kvq_attrs)

    def _dev_mark(self) -> Any:
        """A device mark for a step record (None with tracing off)."""
        return self._devclock.mark() if self._tracer.enabled else None

    def _dev_record(self, name: str, m0: Any, **attrs: Any) -> None:
        """Close a prefill or op span opened by ``_dev_mark`` and queue
        its step record; it is written once the stream has passed it."""
        if m0 is None:
            return
        self._dev_pending.append((name, m0, self._devclock.mark(), attrs))
        self._flush_dev_records()

    def _flush_dev_records(self) -> None:
        """Write the queued records whose end mark the stream has passed
        (stream order: stop at the first one still pending)."""
        clock = self._devclock
        while self._dev_pending and clock.done(self._dev_pending[0][2]):
            name, m0, m1, attrs = self._dev_pending.popleft()
            self._tracer.step(name, clock.to_monotonic(m0),
                              clock.to_monotonic(m1), **attrs)

    def _kv_read_rows(self, snapshot: list[tuple[int, _Request]],
                      kv_len: int) -> int:
        """KV rows one decode step streams: the attention kernels prune
        each slot to its length (whole blocks on the paged tier)."""
        bs = self.kv_block_size if self.paged else 1
        return sum(min(kv_len, blocks_for(int(self._positions[s]), bs) * bs)
                   for s, _ in snapshot)

    def scheduler_debug(self) -> dict:
        """The scheduler's state and its queued entries (position,
        priority, remaining deadline)."""
        return {"stats": self._sched.stats(),
                "queued": self._sched.snapshot(),
                "kv_host": self._kv_pool.stats(),
                "parked_sessions": self._kv_pool.snapshot()}

    # ---- fleet KV migration (router/migrate.py; JAX :2722-2823). These run
    # off the engine thread and touch only the thread-safe host pool, so
    # they work on a replica whose engine thread has died.

    def export_parked_kv(self, session_id: str):
        entry = self._kv_pool.get(session_id)
        return None if entry is None else strip_device(entry)

    def parked_kv_info(self, session_id: str) -> tuple[int, int] | None:
        """(kept tokens, bytes) of a session's parked entry, or None."""
        entry = self._kv_pool.get(session_id)
        return None if entry is None else (entry.kept, entry.nbytes)

    def drop_parked_kv(self, session_id: str) -> bool:
        """Purge one session's parked entry."""
        return self._kv_pool.purge(session_id)

    def import_parked_kv(self, entry) -> bool:
        """Adopt a migrated entry: validate it against this engine's
        cache geometry and tier (a mixed-tier fleet must refuse, never
        restore garbage), fit the stored rows to this engine's layout
        (paged: whole block rows; dense: the power-of-two bucket), copy
        them into fresh pinned tensors owned by this pool (the source's
        rows, numpy arrays off the wire or another replica's tensors, are
        never aliased), then insert. The put is atomic: a refusal at any
        step leaves the pool untouched."""
        if not self._kv_pool.enabled:
            return False
        sid = entry.session_id
        problem = entry_problem(entry)
        if problem is not None:
            log.warning(f"refused migrated KV for {sid}: {problem}")
            return False
        k_dtype = _host_tensor(entry.k).dtype
        L, _, Kv, H = entry.k.shape
        if (L, Kv, H) != (self.cfg.num_layers, self.cfg.num_kv_heads,
                          self.cfg.head_dim):
            log.warning(
                f"refused migrated KV for {sid}: geometry [{L},{Kv},{H}] "
                f"!= engine [{self.cfg.num_layers},{self.cfg.num_kv_heads},"
                f"{self.cfg.head_dim}]")
            return False
        if entry.kept > self.max_len:
            log.warning(f"refused migrated KV for {sid}: kept {entry.kept} "
                        f"exceeds max_len {self.max_len}")
            return False
        if self.kv_quant:
            if entry.k_scale is None or k_dtype != torch.int8 \
                    or entry.k_scale.shape[2] != self.kv_scale_granule:
                log.warning(f"refused migrated KV for {sid}: not int8 rows "
                            f"with granule {self.kv_scale_granule} scales")
                return False
        elif entry.k_scale is not None or k_dtype == torch.int8:
            log.warning(f"refused migrated KV for {sid}: quantized entry "
                        "into a bf16-tier cache")
            return False
        elif k_dtype != self.dtype:
            # dtype is part of the tier: a float32 entry in a bf16 cache
            # passes every shape check but cannot be written into it.
            log.warning(f"refused migrated KV for {sid}: row dtype "
                        f"{k_dtype} != engine cache dtype {self.dtype}")
            return False
        bucket = kv_bucket(entry.kept, self.max_len)
        rows = bucket
        if self.paged:
            bucket = max(bucket, self.kv_block_size)
            rows = blocks_for(entry.kept, self.kv_block_size) \
                * self.kv_block_size
        pin = self.device.type == "cuda"

        def fit(arr):
            if arr is None:
                return None
            t = _host_tensor(arr)
            out = torch.zeros((t.shape[0], rows) + tuple(t.shape[2:]),
                              dtype=t.dtype, pin_memory=pin)
            n = min(rows, t.shape[1])
            out[:, :n] = t[:, :n]
            return out

        k, v = fit(entry.k), fit(entry.v)
        ks, vs = fit(entry.k_scale), fit(entry.v_scale)
        nbytes = sum(t.numel() * t.element_size()
                     for t in (k, v, ks, vs) if t is not None)
        now = time.monotonic()
        entry = replace(strip_device(entry), k=k, v=v, k_scale=ks,
                        v_scale=vs, bucket=bucket, nbytes=nbytes,
                        tokens=list(entry.tokens), parked_at=now,
                        last_used=now, imported=True)
        # A session released here before (tombstoned) comes back through
        # the migration: the tombstone falls only with a successful insert.
        ok = self._kv_pool.put(entry, revive=True)
        if ok:
            # The session's next request is usually already on its way
            # (the handoff's decode stream admits right behind the
            # transfer): stage the rows on the device now.
            self._kv_offload.prestage(entry.session_id)
        return ok

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
            "mesh": dict(self.mesh.shape) if self.mesh is not None else None,
        }

    def get_stats(self) -> dict:
        structured: dict[str, Any] = {
            "available": self.structured_reason is None,
            "calls": self.structured_calls,
            "steps": self.structured_steps,
            "host_s": self.structured_host_s,
            "jump_forward_tokens": self.structured_jump_tokens,
        }
        if self.structured_reason is not None:
            structured["reason"] = self.structured_reason
        if self._st_compiler is not None:
            structured["compiler"] = self._st_compiler.stats()
        if self._st_arena is not None:
            structured["arena"] = self._st_arena.stats()
        out = {"slots": self.slots.stats(), "waiting": len(self._sched),
               "scheduler": self._sched.stats(),
               "kv_quant": "int8" if self.kv_quant else "none",
               "kv_layout": "paged" if self.paged else "dense",
               "prefilling": len(self._prefilling),
               "running": len(self._running),
               "tokens_generated": self.tokens_generated,
               "decode_calls": self.decode_calls,
               "decode_steps": self.decode_steps,
               "decode_host_s": self.decode_host_s,
               "batched_prefill_calls": self.batched_prefill_calls,
               "batched_prefill_rows": self.batched_prefill_rows,
               "ring_prefill_calls": self.ring_prefill_calls,
               "prefix_tokens_shared": self.prefix_tokens_shared,
               "spec": {"mode": self.spec_mode, "draft": self.spec_draft,
                        "ema_tokens_per_verify": self._spec_ema,
                        "calls": self.spec_calls, "steps": self.spec_steps,
                        "host_s": self.spec_host_s,
                        "verify_blocks": self.spec_blocks,
                        "accepted": self.spec_accepted,
                        "drafted": self.spec_drafted,
                        "constrained_calls": self.spec_constrained_calls},
               "structured": structured,
               "kv_host": {**self._kv_pool.stats(),
                           "policy": self._kv_policy.stats(),
                           "restore_failed": self.kv_restore_failed,
                           "park_failed": self._kv_offload.failed_parks}}
        if self.paged:
            used = sum(min(s.kv_written, len(s.tokens))
                       for s in self.slots.slots)
            out["kv_blocks"] = self._kv_blocks.stats(used_tokens=used)
        if self._kv_radix is not None:
            # The tree is the engine thread's: a walk that meets one of its
            # changes (a dict resized mid-iteration) is taken again.
            for attempt in range(3):
                try:
                    out["kv_radix"] = self._kv_radix.stats()
                    break
                except RuntimeError:
                    if attempt == 2:
                        raise
        return out

    # ---------------- engine thread ----------------

    def _run(self) -> None:
        log.info("engine thread started", model=self.cfg.name,
                 slots=self.num_slots, max_len=self.max_len,
                 device=str(self.device))
        reason = "engine shut down"
        try:
            if self._cuda_index is not None:
                # A new thread (a restart's too) binds the engine's card.
                torch.cuda.set_device(self._cuda_index)
            self._devclock.anchor()
            while True:
                # Watchdog heartbeat: one float store per pass; an idle
                # loop still passes every 50 ms (the command timeout).
                self._hb_mono = time.monotonic()
                if _fp.enabled:
                    # Chaos seam: crash_thread or hang the engine thread
                    # itself (the supervisor-restart and watchdog drills).
                    _fp.fire("engine.loop.tick")
                idle = not self._running and not self._inflight \
                    and not self._prefilling and not self._pending_firsts
                if idle and self._dev_pending:
                    self._flush_dev_records()
                if idle and not self._dev_pending and self._tracer.enabled:
                    self._devclock.maybe_reanchor(self._hb_mono)
                if not self._drain_commands(block=idle):
                    break
                if len(self._sched):
                    if not self._running and not self._inflight \
                            and not self._prefilling:
                        # Burst coalescing (JAX _run): from idle, the first
                        # request of a concurrent burst lands a few ms
                        # before the rest; a short grace gathers the burst
                        # into one admission group, one batched prefill.
                        stop = False
                        for _ in range(2):
                            time.sleep(0.003)
                            if not self._drain_commands(block=False):
                                stop = True
                                break
                        if stop:
                            break
                    self._admit()
                if self._prefilling:
                    self._advance_prefill()
                if self._pending_firsts:
                    self._drain_firsts(block=not self._inflight and not (
                        self._running and self._should_dispatch()))
                if self._st_jf_pending and not self._inflight:
                    # Jump-forward runs on an empty pipeline only (the host
                    # FSM mirrors are then authoritative); while one is
                    # pending, dispatch pauses so the pipeline drains.
                    self._st_jump_forward()
                if self._running and self._should_dispatch() \
                        and not self._st_jf_pending:
                    self._dispatch_decode()
                    if len(self._inflight) >= self.pipeline_depth:
                        self._retire_oldest()
                elif self._inflight:
                    self._retire_oldest()
                self._m_active.set(len(self._running))
                self._m_queue.set(len(self._sched) + len(self._prefilling))
                self._kv_tick()
        except (_fp.FaultCrash, Exception) as e:
            # FaultCrash is a BaseException (it escapes every scoped
            # handler as a real fault would); a crash here still ends every
            # request with its reason and sets _stopped for the supervisor.
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
            if req.fsm is not None:
                # The abort path bypasses _finish: unpin the FSM here.
                self._st_release(req)
            self._record_slo(req, ok=False)
            self._emit(req, {"type": "error", "error": reason,
                             "code": "internal_error"})
        self._by_id.clear()
        self._sched.clear()
        self._prefilling.clear()
        self._running.clear()
        self._inflight.clear()
        self._pending_firsts.clear()
        self._st_jf_pending.clear()

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
            if cmd == "cancel":
                req = self._by_id.get(arg)
                if req is not None:
                    req.cancelled = True
                    if self._sched.cancel(arg) is not None:
                        self._finish(req, "cancelled")  # still queued
            elif cmd == "release":
                # The session is over: its parked entry goes too (and is
                # tombstoned against a park still in flight).
                self._kv_pool.purge(arg)
                slot = self.slots.lookup(arg)
                if slot is not None and slot.active:
                    self._release_after.add(arg)
                else:
                    self.slots.release_session(arg)
            # "kick": a submission landed in the scheduler; just wake.

    def _expire_queued(self) -> None:
        """End every queued request past its deadline with a terminal
        event before it touches the card (JAX _expire_queued :4047)."""
        now = time.monotonic()
        for entry in self._sched.take_expired():
            req = entry.payload
            if req is None or req.finished:
                continue
            if self._tracer.enabled:
                self._tracer.add_span(req.request_id, "queue_wait",
                                      req.submitted_at, now,
                                      priority=entry.priority,
                                      expired=True)
            self._finish(
                req, "error",
                error=f"request expired after {now - req.submitted_at:.1f}s "
                f"in the admission queue (deadline "
                f"{entry.deadline - entry.submitted_at:.1f}s)",
                code="deadline_expired",
                retry_after=self._sched.retry_after())

    def _admit(self) -> None:
        """Move queued requests into free slots, in the scheduler's order
        (priority class with bulk aging, round-robin across sessions,
        deadlines enforced). A request whose session is still generating
        is skipped without blocking others. Requests whose remaining prompt
        fits one prefill bucket prefill together (``_prefill_batched``);
        longer ones take the chunked path."""
        self._expire_queued()
        # From idle nobody waits behind a long prefill, so one batched
        # call may take prompts up to the 1024 bucket (JAX :4088-4101).
        idle = not self._running and not self._inflight \
            and not self._prefilling
        allowed = max(self.prefill_chunk, 1024) if idle \
            else self.prefill_chunk
        batch: list[_Item] = []
        busy = {s.session_id for s in self.slots.slots
                if s.active and s.session_id is not None}
        while True:
            entry = self._sched.pop(busy)
            if entry is None:
                break
            req = entry.payload
            if req.finished:
                continue
            if req.cancelled:
                self._finish(req, "cancelled")
                continue
            slot = self.slots.acquire(req.session_id)
            if slot is None:  # every slot is decoding
                self._sched.requeue_front(entry)
                break
            if self._kv_pool.enabled:
                # Admission proves the session alive: clear a release
                # tombstone (callers may reuse ids after a release).
                self._kv_pool.revive(req.session_id)
            # Reserved now: activation follows the prefill, and an
            # unreserved slot could be evicted by the next acquire.
            req.slot = slot
            slot.active = True
            busy.add(req.session_id)
            req.admitted_at = time.monotonic()
            self._m_queue_wait.observe(
                (req.admitted_at - req.submitted_at) * 1000)
            if self._tracer.enabled:
                self._tracer.add_span(req.request_id, "queue_wait",
                                      req.submitted_at, req.admitted_at,
                                      slot=slot.index,
                                      priority=entry.priority)
                self._tracer.set_phase(req.request_id, "prefill")
            prompt = req.prompt_tokens
            reused = self.slots.reuse_prefix(slot, prompt)
            if self.paged:
                # Blocks past the trusted rows (a diverged history) go
                # back, and a shared tail block is copied before any write
                # can land in it.
                self._paged_sync_resident(slot)
                reused = min(reused, slot.kv_written)
            if reused:
                self._m_prefix.inc(reused)
            if not reused:
                # The radix tree's longest cached chain, unless a longer
                # parked entry of this session should restore instead.
                reused = self._radix_admit(req, slot, prompt)
            if not reused:
                reused = self._try_restore(req, slot, prompt)
            if not reused and self.shared_prefix:
                reused = self._share_from_other_slot(slot, prompt)
            todo = prompt[reused:]
            req.prefill_tokens = len(todo)
            if reused + len(todo) > self.usable_len:
                self._finish(req, "error", error=f"prompt ({len(prompt)} "
                             "tok) exceeds context")
                continue
            if self.paged and not self._paged_admissible(slot, req, reused,
                                                         len(todo)):
                continue  # shed with retry_after: the blocks do not fit
            if req.fsm is not None:
                # Constrained admission (JAX :4216-4225): pin the FSM into
                # the arena and take the single-slot prefill, whose
                # completion samples the first token under the start
                # state's mask (the batched group samples unmasked).
                try:
                    self._st_register(req)
                except ArenaFull as e:
                    self._finish(req, "error", error=str(e),
                                 code="structured_capacity")
                    continue
                self._prefilling.append(_PrefillState(
                    req=req, slot=slot, start=reused, todo=todo))
                continue
            bucket = next((b for b in _PREFILL_BUCKETS if b >= len(todo)),
                          None)
            if bucket is not None and len(todo) <= allowed \
                    and reused + bucket <= self.max_len \
                    and not req.params.prefill_only \
                    and not self._ring_prefill_eligible(reused, len(todo)):
                batch.append((req, slot, reused, todo))
            else:
                # Long prompts, and on an sp > 1 mesh fresh prompts of at
                # least one rank's KV shard (ring prefill), take the
                # single-slot path (JAX :4237-4247).
                self._prefilling.append(_PrefillState(
                    req=req, slot=slot, start=reused, todo=todo))
        if batch:
            if self.shared_prefix and len(batch) >= 2:
                self._prefill_batched_shared(batch)
            else:
                self._prefill_batched(batch)
        # Entries the pop found expired end now: the queue may be empty,
        # and no later iteration would come back for them.
        self._expire_queued()

    # ---------------- shared prefix ----------------

    def _share_from_other_slot(self, slot: Slot, prompt: list[int]) -> int:
        """Cross-session stamp: the longest prefix resident in another slot
        serves this fresh one. Dense: a row copy rounded down to the stamp
        granule (JAX ``_stamp_prefix`` :2343); paged: the source's full
        blocks are aliased and a partially shared tail block copied (JAX
        ``_paged_alias`` :2978). The source's rows [0, share) are stable:
        its own writes go to positions at or past its kept length. Returns
        the prompt tokens now resident."""
        src, share = self.slots.best_shared_prefix(slot, prompt)
        if src is None:
            return 0
        if self.paged:
            share = self._paged_alias(src, slot, share)
        else:
            share -= share % self._STAMP_GRANULE
            if share < self._STAMP_GRANULE:
                return 0
            self._copy_prefix(src, slot, share)
        if share:
            slot.tokens = list(prompt[:share])
            slot.kv_written = share
            self._count_shared(share)
        return share

    def _count_shared(self, rows: int) -> None:
        self.prefix_tokens_shared += rows
        self._m_shared.inc(rows)

    def _copy_prefix(self, src: Slot, dst: Slot, rows: int) -> None:
        """Copy the source slot's leading ``rows`` rows of the dense cache
        (and their scale rows on the int8 tier) onto ``dst``. PyTorch has
        no executable family to bound, so one slice copy serves any length
        (JAX decomposes the share into power-of-two chunks, :2362-2379)."""
        self._call("prefix_copy", src=src.index, dst=dst.index, rows=rows)

    def _prefill_batched_shared(self, batch: list[_Item]) -> None:
        """Intra-burst shared prefix (JAX :4421): when fresh admissions of
        one burst share a long leading prefix, prefill the longest prompt
        first, give the shared rows to the others (dense: a row copy;
        paged: the leader's blocks aliased) and batch-prefill only their
        deltas. A share that cannot shrink a member's prefill bucket is
        skipped (two waves would be slower than one). The JAX engine
        copies dense rows on the paged tier too and fails there (ROADMAP
        Queue C); the paged members here alias as every other paged share
        does."""
        fresh = [item for item in batch if item[2] == 0]
        members: list[tuple[_Item, int]] = []
        leader = None
        if len(fresh) >= 2:
            leader = max(fresh, key=lambda it: len(it[0].prompt_tokens))
            lp = leader[0].prompt_tokens
            for item in fresh:
                if item is leader:
                    continue
                pt = item[0].prompt_tokens
                share = _lcp(lp, pt, min(len(lp), len(pt) - 1))
                share -= share % self._STAMP_GRANULE
                if share < self._INTRA_SHARE_MIN:
                    continue
                full_b = next(b for b in _PREFILL_BUCKETS if b >= len(pt))
                delta_b = next(b for b in _PREFILL_BUCKETS
                               if b >= max(1, len(pt) - share))
                if delta_b < full_b and share + delta_b <= self.max_len:
                    members.append((item, share))
        if not members:
            self._prefill_batched(batch)
            return
        member_ids = {id(it) for it, _ in members}
        self._prefill_batched([it for it in batch if id(it) not in member_ids])
        lreq, lslot = leader[0], leader[1]
        second: list[_Item] = []
        for (req, slot, _, _), share in members:
            if req.finished:
                continue
            # Re-clamp to what the leader wrote, and re-check that the
            # (possibly larger) delta's bucket still fits at its start.
            share = min(share, lslot.kv_written)
            share -= share % self._STAMP_GRANULE
            delta_b = next((b for b in _PREFILL_BUCKETS
                            if b >= max(1, len(req.prompt_tokens) - share)),
                           None)
            if lreq.finished or share < self._INTRA_SHARE_MIN \
                    or delta_b is None or share + delta_b > self.max_len:
                second.append((req, slot, 0, req.prompt_tokens))
                continue
            if self.paged:
                if self._paged_alias(lslot, slot, share) != share:
                    # The tail block found no free block: share nothing.
                    self._kv_blocks.release(slot.index)
                    second.append((req, slot, 0, req.prompt_tokens))
                    continue
            else:
                self._copy_prefix(lslot, slot, share)
            slot.tokens = list(req.prompt_tokens[:share])
            slot.kv_written = share
            req.prefill_tokens = len(req.prompt_tokens) - share
            self._count_shared(share)
            second.append((req, slot, share, req.prompt_tokens[share:]))
        if second:
            self._prefill_batched(second)

    # ---------------- prefill ----------------

    def _prefill_batched(self, batch: list[_Item]) -> None:
        """Prefill single-bucket prompts in one forward per bucket, at most
        ``num_slots`` rows a group; an error ends only its group."""
        t0 = time.monotonic()
        by_bucket: dict[int, list[_Item]] = {}
        for item in batch:
            bucket = next(b for b in _PREFILL_BUCKETS
                          if b >= max(1, len(item[3])))
            by_bucket.setdefault(bucket, []).append(item)
        for bucket, group in sorted(by_bucket.items()):
            while group:
                sub, group = group[:self.num_slots], group[self.num_slots:]
                try:
                    self._prefill_group(bucket, sub)
                except Exception as e:
                    log.error(f"batched prefill failed: {e}", exc_info=True)
                    for req, _, _, _ in sub:
                        self._finish(req, "error", error=str(e))
        self._m_prefill.observe((time.monotonic() - t0) * 1000)

    def _prefill_group(self, bucket: int, sub: list[_Item]) -> None:
        """One ``[group, bucket]`` forward and one first-token sample for a
        same-bucket group. The target slots' first ``ctx`` rows are
        gathered (dense: by slot; paged: through each row's table), the
        chunk's rows scattered back; each row writes from its own start.
        PyTorch needs no fixed group shape, so the group has no padding
        rows (JAX pads to 1 or num_slots to bound its executables)."""
        if _fp.enabled:
            # The chunked path's seam name: _prefill_batched's handler
            # scopes an `error` to this group's requests.
            _fp.fire("engine.prefill.dispatch",
                     request_id=";".join(r.request_id for r, _, _, _ in sub))
        if self.paged:
            # Blocks for every row's padded write horizon before anything
            # is built: a row the pool cannot hold sheds here and the rest
            # of the group proceeds (JAX :4533-4552).
            kept = []
            for item in sub:
                if self._kv_blocks.ensure(item[1].index, item[2] + bucket):
                    kept.append(item)
                else:
                    self._paged_exhausted_finish(
                        item[0], "KV block pool exhausted during "
                                 "batched prefill")
            sub = kept
            if not sub:
                return
        g = len(sub)
        m0 = self._dev_mark()
        tokens = np.zeros((g, bucket), np.int64)
        for j, (_, _, _, todo) in enumerate(sub):
            tokens[j, :len(todo)] = todo
        starts = [start for _, _, start, _ in sub]
        ctx = _kv_bucket(max(starts) + bucket, self.max_len)
        # Per row: slot, start, last real index, temperature, top-k, top-p
        # (JAX packs the same row config, :3700).
        rowcfg = np.array([[slot.index, start, len(todo) - 1,
                            req.params.temperature, req.params.top_k,
                            req.params.top_p]
                           for req, slot, start, todo in sub], np.float64)
        firsts = self._call("batched_prefill", tokens=tokens, rowcfg=rowcfg)
        # One step record: g x bucket rows computed, the real prompt
        # tokens useful (the port pads no group rows).
        real = sum(len(todo) for _, _, _, todo in sub)
        self._dev_record(
            "engine_prefill", m0, bucket=bucket, tokens=real,
            rows=g * bucket, kind="batched", group=g,
            program=program_key(
                "batched_prefill", chunk=bucket, group=g, ctx=ctx,
                **self._kvq_attrs,
                **({"kv_layout": "paged"} if self.paged else {})),
            flops=self._perf.call_flops(real, ctx))
        self.batched_prefill_calls += 1
        self.batched_prefill_rows += g
        entries = []
        for j, (req, slot, start, todo) in enumerate(sub):
            slot.tokens.extend(todo)
            slot.kv_written = start + len(todo)
            self._activate(req, slot)
            entries.append((j, slot.index, req))
        self._defer_first(firsts, entries)

    def _advance_prefill(self) -> None:
        """Run ONE chunk of the oldest in-progress long prefill."""
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
            if _fp.enabled:
                # Chaos seam: `error` is scoped to this request by the
                # handler below; `crash_thread` escapes it and kills the
                # thread.
                _fp.fire("engine.prefill.dispatch",
                         request_id=req.request_id,
                         session_id=req.session_id)
            ring = self._ring_prefill_eligible(st.start, len(st.todo))
            if ring:
                # The whole fresh prompt in one ring-attention call (JAX
                # :4286-4300): per-rank attention memory O(T/sp).
                take = len(st.todo)
                padded = np.zeros((ring,), np.int64)
                padded[:take] = st.todo
                prog = program_key("ring_prefill", bucket=ring)
                m0 = self._dev_mark()
                st.last_logits = self._call("ring_prefill", tokens=padded,
                                            slot=slot.index, last=take - 1)
                self.ring_prefill_calls += 1
                bucket = ring
            else:
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
                    # The padded bucket writes up to start + bucket:
                    # without its blocks the padding would land in another
                    # slot's.
                    self._prefilling.pop(0)
                    self._paged_exhausted_finish(
                        req, "KV block pool exhausted during prefill")
                    return
                prog = self._prefill_program(st.start, bucket)
                m0 = self._dev_mark()
                st.last_logits = self._run_chunk_prefill(
                    slot, st.todo[:take], st.start, bucket)
            chunk = st.todo[:take]
            slot.tokens.extend(chunk)
            st.start += take
            slot.kv_written = st.start
            st.todo = st.todo[take:]
            self._dev_record("engine_prefill", m0, bucket=bucket,
                             tokens=take, rows=bucket,
                             kind="ring" if ring else "chunk", program=prog,
                             flops=self._perf.call_flops(take, st.start))
            # A chunk is forward progress for every request in the
            # prefill FIFO, not only the head (JAX :4362-4370).
            now = time.monotonic()
            for waiting in self._prefilling:
                waiting.req.last_progress_at = now
            if st.todo:
                return  # next chunk on a later iteration
            self._prefilling.pop(0)
            self._m_prefill.observe((time.monotonic() - st.t0) * 1000)
            if req.params.prefill_only:
                # Disaggregated prefill tier: park the written rows and
                # finish without sampling or activating (JAX :4375-4382).
                self._prefill_park_finish(req, slot)
                return
            if req.fsm is not None:
                self._activate(req, slot)
                self._st_sample_place(req, slot, st.last_logits)
                return
            first = self._call("sample_place", slot=slot.index,
                               temp=req.params.temperature,
                               topk=req.params.top_k, topp=req.params.top_p)
            self._activate(req, slot)
            self._defer_first(first, [(0, slot.index, req)])
        except Exception as e:
            log.error(f"prefill failed for {req.request_id}: {e}",
                      exc_info=True)
            if self._prefilling and self._prefilling[0] is st:
                self._prefilling.pop(0)
            self._finish(req, "error", error=str(e))

    def _dev_scalar(self, value: float, dtype: torch.dtype) -> torch.Tensor:
        return torch.tensor([value], dtype=dtype, device=self.device)

    def _run_chunk_prefill(self, slot: Slot, chunk: list[int], start: int,
                           bucket: int) -> torch.Tensor | None:
        """One prompt chunk for one slot (``_dc_prefill``); returns the last
        real token's logits [V] (None on a rank of another "dp" group)."""
        padded = np.zeros((bucket,), np.int64)
        padded[:len(chunk)] = chunk
        return self._call("prefill", tokens=padded, start=start,
                          slot=slot.index, last=len(chunk) - 1)

    # ---------------- replayable device calls ----------------
    # Each ``_dc_<kind>`` takes host values only and is the whole of one
    # device call: the leader runs it through ``_call`` (which publishes
    # it first), a follower runs it from the leader's stream
    # (parallel/spmd_serving.py ``follower_loop``). Slots are global
    # indices; each call works on the ones this rank holds.

    def _call(self, kind: str, **payload: Any) -> Any:
        """Publish one device call to the call sink (an SPMD leader's
        followers replay it), then run it here (JAX ``_sink`` :1760)."""
        if self.call_sink is not None:
            self.call_sink(kind, payload)
        return getattr(self, f"_dc_{kind}")(**payload)

    def _local_rows(self, slots: Any) -> tuple[list[int], list[int]]:
        """(positions in ``slots``, local slot indices) of the slots this
        rank holds."""
        lo, n = self._slot_lo, self.local_slots
        pick, local = [], []
        for j, s in enumerate(slots):
            if lo <= int(s) < lo + n:
                pick.append(j)
                local.append(int(s) - lo)
        return pick, local

    def _gather_slots(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every "dp" group's slot rows of ``t``, in slot order."""
        if self._dp == 1:
            return t
        return collectives.all_gather(t.contiguous(), self.mesh, "dp", dim)

    def _seq_view(self, slot_idx: torch.Tensor, ctx: int) -> KVCache:
        """A dense copy of the first ``ctx`` cache rows of local slots; with
        sp > 1 each rank's sequence shard is gathered over "sp"."""
        if self._sp == 1:
            return KVCache(*(None if x is None else x[:, slot_idx, :ctx]
                             for x in self.cache))
        return KVCache(*(
            None if x is None else collectives.all_gather(
                x[:, slot_idx].contiguous(), self.mesh, "sp", dim=2)[:, :, :ctx]
            for x in self.cache))

    def _write_back(self, view: KVCache, slot_idx: torch.Tensor,
                    positions: torch.Tensor) -> None:
        """Scatter the rows at ``positions`` [g, T] of a gathered copy back
        into the cache (with sp > 1, the positions this rank holds)."""
        rows = torch.arange(positions.shape[0],
                            device=positions.device)[:, None]
        for part, full in zip(view, self.cache):
            if full is None:
                continue
            new = part[:, rows, positions]
            if self._sp > 1:
                cols = positions - self._seq_lo
                keep = (cols >= 0) & (cols < full.shape[2])
                jj, tt = keep.nonzero(as_tuple=True)
                full[:, slot_idx[jj], cols[jj, tt]] = new[:, jj, tt]
            else:
                full[:, slot_idx[:, None], positions] = new

    def _ring_prefill_eligible(self, start: int, n_tokens: int) -> int:
        """The power-of-two bucket of a fresh prompt that prefills through
        ring attention, else 0 (JAX :3602-3622): an sp > 1 mesh, a fresh
        slot, and at least one rank's KV shard of prompt."""
        if self.mesh is None or start != 0 or self._sp <= 1:
            return 0
        if n_tokens < max(256, self.max_len // self._sp):
            return 0
        bucket = 1 << (n_tokens - 1).bit_length()
        bucket = max(bucket, 2 * self._sp)
        if bucket > self.max_len or bucket % self._sp:
            return 0
        return bucket

    def _step_kw(self) -> dict:
        return dict(sample_vocab=self.sample_vocab,
                    method=self.sampling_method,
                    block_size=self.kv_block_size if self.paged else 0,
                    mesh=self._mesh_arg)

    def _dc_decode(self, kv_len: int, steps: int,
                   fsm: FSMTables | None = None) -> torch.Tensor:
        """``steps`` plain decode steps; the tokens [K, S] of every slot."""
        toks = plain_steps(self.params, self.cfg, self.cache, self._dev,
                           steps, kv_len, table=self._decode_table(kv_len),
                           fsm=fsm, **self._step_kw())
        return self._gather_slots(toks, 1)

    def _dc_spec(self, kv_len: int, steps: int) -> torch.Tensor:
        """``steps`` speculative steps; [K, S, T + 1] of every slot."""
        out = spec_steps(self.params, self.cfg, self.cache, self._dev, steps,
                         kv_len, self.spec_draft,
                         table=self._decode_table(kv_len), **self._step_kw())
        return self._gather_slots(out, 1)

    def _dc_patch(self, packed: np.ndarray, slots: np.ndarray) -> None:
        """Slot state rows (position, active, sampling parameters) onto
        the device; their penalty counts restart at 0."""
        pick, local = self._local_rows(slots)
        if not pick:
            return
        st = self._dev
        vals = torch.from_numpy(packed[pick]).to(self.device)
        ii = torch.as_tensor(local, device=self.device)
        st.pos[ii] = vals[:, 0].to(torch.int64)
        st.active[ii] = vals[:, 1] > 0.5
        st.temps[ii] = vals[:, 2].to(torch.float32)
        st.topks[ii] = vals[:, 3].to(torch.int64)
        st.topps[ii] = vals[:, 4].to(torch.float32)
        st.reps[ii] = vals[:, 5].to(torch.float32)
        st.press[ii] = vals[:, 6].to(torch.float32)
        st.freqs[ii] = vals[:, 7].to(torch.float32)
        st.counts[ii] = 0

    def _dc_hist_patch(self, rows: np.ndarray, slots: np.ndarray) -> None:
        """Draft-history rows of newly activated slots."""
        pick, local = self._local_rows(slots)
        if not pick:
            return
        st = self._dev
        ii = torch.as_tensor(local, device=self.device)
        st.history[ii] = 0
        st.history[ii, :rows.shape[1]] = torch.from_numpy(
            np.ascontiguousarray(rows[pick])).to(self.device)

    def _dc_prefix_copy(self, src: int, dst: int, rows: int) -> None:
        """The source slot's leading ``rows`` rows (and scale rows) copied
        onto ``dst`` (never on a "dp" mesh: shared prefixes are off)."""
        pick, local = self._local_rows([src, dst])
        if len(pick) < 2:
            return
        n = max(0, min(rows - self._seq_lo, self.max_len // self._sp))
        for part in self.cache:
            if part is not None:
                part[:, local[1], :n] = part[:, local[0], :n]

    def _dc_batched_prefill(self, tokens: np.ndarray,
                            rowcfg: np.ndarray) -> torch.Tensor:
        """One ``[group, bucket]`` forward and one first-token sample for
        a same-bucket group (rows: slot, start, last, temperature, top-k,
        top-p); the first tokens go into the slots' current tokens and are
        returned [g]. Each "dp" group runs its own rows."""
        g, bucket = tokens.shape
        dev = self.device
        slots = rowcfg[:, 0].astype(np.int64)
        starts = rowcfg[:, 1].astype(np.int64)
        ctx = _kv_bucket(int(starts.max()) + bucket, self.max_len)
        pick, local = self._local_rows(slots)
        firsts = None
        if pick:
            cfg = rowcfg[pick]
            starts_t = torch.as_tensor(starts[pick], device=dev)
            positions = starts_t[:, None] \
                + torch.arange(bucket, device=dev)[None]
            slot_idx = torch.as_tensor(local, device=dev)
            if self.paged:
                read = torch.stack([self._paged_read_indices(int(s), ctx)
                                    for s in slots[pick]])
                view = KVCache(*(None if x is None else x[:, read]
                                 for x in self.cache))
            else:
                view = self._seq_view(slot_idx, ctx)
            logits, _ = forward(
                self.params, self.cfg,
                torch.from_numpy(np.ascontiguousarray(tokens[pick])).to(dev),
                positions, view, starts_t, blockwise=True,
                logits_indices=torch.as_tensor(
                    cfg[:, 2].astype(np.int64), device=dev),
                mesh=self._mesh_arg)
            # Only the chunk's rows go back: the gathered copy holds the
            # rest unchanged.
            if self.paged:
                rows = torch.arange(len(pick), device=dev)[:, None]
                for part, full in zip(view, self.cache):
                    if full is not None:
                        full[:, read.gather(1, positions)] = \
                            part[:, rows, positions]
            else:
                self._write_back(view, slot_idx, positions)
            firsts = sample_tokens(
                logits[:, 0, :self.sample_vocab], self._dev.gen,
                torch.as_tensor(cfg[:, 3], dtype=torch.float32, device=dev),
                torch.as_tensor(cfg[:, 4].astype(np.int64), device=dev),
                torch.as_tensor(cfg[:, 5], dtype=torch.float32, device=dev),
                method=self.sampling_method)
            self._dev.cur[slot_idx] = firsts
        if self._dp > 1:
            return self._gather_slots(self._dev.cur, 0)[
                torch.as_tensor(slots, device=dev)]
        return firsts

    def _dc_prefill(self, tokens: np.ndarray, start: int, slot: int,
                    last: int) -> torch.Tensor | None:
        """One prompt chunk for one slot, written into the slot's cache
        rows; keeps and returns the logits [V] of index ``last`` (None on
        a rank of another "dp" group). Attention reads the slot's first
        ``ctx`` rows, a KV bucket covering the chunk.

        Paged: the slot's logical rows 0..ctx are gathered out of the pool
        into a dense [L, 1, ctx, ...] copy, the unchanged dense ``forward``
        runs over it, and the chunk's rows start..start+bucket scatter
        back through the table (their blocks were ensured by the caller).
        With sp > 1 the slot's rows are gathered over "sp" and the chunk's
        rows go back to the ranks that hold them."""
        pick, local = self._local_rows([slot])
        self._last_logits = None
        if not pick:
            return None
        dev = self.device
        bucket = len(tokens)
        ctx = _kv_bucket(start + bucket, self.max_len)
        tok = torch.from_numpy(np.ascontiguousarray(tokens[None])).to(dev)
        positions = start + torch.arange(bucket, device=dev)[None]
        slot_idx = torch.as_tensor(local, device=dev)
        if self.paged:
            read = self._paged_read_indices(slot, ctx)
            view = KVCache(*(None if x is None else x[:, read][:, None]
                             for x in self.cache))
        elif self._sp > 1:
            view = self._seq_view(slot_idx, ctx)
        else:
            rows = slice(local[0], local[0] + 1)
            view = KVCache(*(None if x is None else x[:, rows, :ctx]
                             for x in self.cache))
        logits, _ = forward(
            self.params, self.cfg, tok, positions, view,
            torch.tensor([start], device=dev), blockwise=True,
            logits_indices=torch.tensor([last], device=dev),
            mesh=self._mesh_arg)
        if self.paged:
            # ctx >= start + bucket (the caller keeps the bucket inside
            # max_len), so the chunk's pool rows are a slice of the read's.
            write = read[start:start + bucket]
            for pool, part in zip(self.cache, view):
                if pool is not None:
                    pool[:, write] = part[:, 0, start:start + bucket]
        elif self._sp > 1:
            self._write_back(view, slot_idx, positions)
        self._last_logits = logits[0, 0]
        return self._last_logits

    def _dc_ring_prefill(self, tokens: np.ndarray, slot: int,
                         last: int) -> torch.Tensor | None:
        """A fresh prompt (padded to a power-of-two bucket) through ring
        attention into the slot's rows (``forward_ring``); keeps and
        returns the logits [V] of index ``last``."""
        pick, local = self._local_rows([slot])
        self._last_logits = None
        if not pick:
            return None
        s = local[0]
        view = KVCache(*(None if x is None else x[:, s:s + 1]
                         for x in self.cache))
        self._last_logits = forward_ring(
            self.params, self.cfg,
            torch.from_numpy(np.ascontiguousarray(tokens[None])).to(
                self.device), view, self.mesh, last)
        return self._last_logits

    def _dc_sample_place(self, slot: int, temp: float, topk: int,
                         topp: float) -> torch.Tensor:
        """The first token of a chunked or ring prefill, sampled from the
        kept logits into the slot's current token; returned [1]."""
        pick, local = self._local_rows([slot])
        first = None
        if pick:
            first = sample_tokens(
                self._last_logits[None, :self.sample_vocab], self._dev.gen,
                self._dev_scalar(temp, torch.float32),
                self._dev_scalar(topk, torch.int64),
                self._dev_scalar(topp, torch.float32),
                method=self.sampling_method)
            self._dev.cur[local[0]] = first[0]
        if self._dp > 1:
            return self._gather_slots(self._dev.cur, 0)[slot:slot + 1]
        return first

    def _activate(self, req: _Request, slot: Slot) -> None:
        s = slot.index
        slot.active = True
        req.slot = slot
        req.decode_started_at = time.monotonic()
        req.last_progress_at = req.decode_started_at
        if req.admitted_at is not None:
            self._m_prefill_req.observe(
                (req.decode_started_at - req.admitted_at) * 1000)
            if req.prefill_tokens:
                # Measured prefill throughput: the restore policy's cost
                # model (admission to activation, the overheads a restore
                # competes against; JAX :4665-4677).
                self._kv_policy.note_prefill(
                    req.prefill_tokens,
                    req.decode_started_at - req.admitted_at)
            if self._tracer.enabled:
                self._tracer.add_span(
                    req.request_id, "prefill", req.admitted_at,
                    req.decode_started_at, slot=s,
                    prompt_tokens=len(req.prompt_tokens))
                self._tracer.set_phase(req.request_id, "decode")
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
        if req.fsm_entry is not None:
            # The slot's row of the arena's class table, shipped with every
            # constrained call.
            self._st_sel[s] = req.fsm_entry.sel
            self._st_sel_dev = None
        if self.spec_draft:
            # Every row fed so far (reused, copied and prefilled alike)
            # goes into the slot's draft history at the next patch.
            self._dirty_history[s] = list(slot.tokens)

    def _defer_first(self, firsts: torch.Tensor,
                     entries: list[tuple[int, int, _Request]]) -> None:
        """Queue first sampled tokens for emission once their copy to the
        host lands."""
        for _, _, req in entries:
            req.first_pending = True
        self._pending_firsts.append((_HostCopy(firsts), entries))

    def _drain_firsts(self, block: bool) -> None:
        while self._pending_firsts:
            copy, entries = self._pending_firsts[0]
            if not block and not copy.done():
                return
            self._pending_firsts.popleft()
            arr = copy.result()
            for j, s, req in entries:
                req.first_pending = False
                if req.finished or self._running.get(s) is not req:
                    continue
                self._consume_token(req, int(arr[j]))
                self._flush_emit(req)

    # ---------------- decode ----------------

    def _should_dispatch(self) -> bool:
        """Dispatch another K-step call only if some running request can
        still use tokens beyond what in-flight calls already promise it."""
        if self._pending_firsts and self._running and all(
                req.first_pending for req in self._running.values()):
            return False
        promised: dict[int, float] = {}
        for call in self._inflight:
            for _, req in call.snapshot:
                promised[id(req)] = promised.get(id(req), 0) + call.promise
        return any(
            req.params.max_tokens - req.generated
            - (1 if req.first_pending else 0) > promised.get(id(req), 0)
            for req in self._running.values())

    def _patch_slot_state(self) -> None:
        """Apply changed host mirrors onto the device decode state with one
        small upload (and the draft history of newly activated slots with
        one more); in-flight calls are ordered before it on the stream."""
        st = self._dev
        if self._st_dirty:
            # FSM-state resets and refreshes (finish -> FREE, an arena
            # repack), from the host mirrors.
            idx = sorted(self._st_dirty)
            self._st_dirty.clear()
            vals = self._upload(np.array(
                [[s, self._st_global_state(s)] for s in idx], np.int64))
            st.fst[vals[:, 0]] = vals[:, 1]
        if self._dirty_history:
            idx = sorted(self._dirty_history)
            longest = max(len(self._dirty_history[s]) for s in idx)
            rows = np.zeros((len(idx), max(1, longest)), np.int64)
            for i, s in enumerate(idx):
                toks = self._dirty_history[s]
                rows[i, :len(toks)] = toks
            self._dirty_history.clear()
            self._call("hist_patch", rows=rows,
                       slots=np.asarray(idx, np.int64))
        if not self._dirty_slots:
            return
        idx = sorted(self._dirty_slots)
        self._dirty_slots.clear()
        packed = np.stack([self._positions[idx], self._active_mask[idx],
                           self._temps[idx], self._topks[idx],
                           self._topps[idx], self._reps[idx],
                           self._press[idx], self._freqs[idx]],
                          axis=1).astype(np.float64)
        self._call("patch", packed=packed, slots=np.asarray(idx, np.int64))

    def _spec_call_wanted(self) -> bool:
        """Per-call speculative/plain choice (JAX :4814): "ngram" always;
        "auto" while the EMA of tokens per verify block clears the
        break-even, else plain with a probe every ``_spec_probe_every``
        calls so the EMA follows the workload."""
        if self.spec_mode == "ngram":
            return True
        if self._spec_ema >= self.spec_breakeven:
            return True
        self._spec_probe_countdown -= 1
        if self._spec_probe_countdown <= 0:
            self._spec_probe_countdown = self._spec_probe_every
            return True
        return False

    def _dispatch_decode(self) -> None:
        """Launch one K-step decode call; does not wait for results."""
        if _fp.enabled:
            # Chaos seam: an `error` here is a dispatch failure; it reaches
            # _run's crash handler (terminal events for every request, a
            # supervisor restart), as a real launch fault would.
            _fp.fire("engine.decode.dispatch")
        steps = (self.steps_burst if len(self._sched) or self._prefilling
                 or any(r.first_pending for r in self._running.values())
                 else self.steps_per_call)
        t = self.spec_draft + 1
        worst_adv = steps * t
        # Paged: blocks first, so that a shed's deactivation reaches this
        # very call through the patch below.
        if self.paged and not self._paged_prepare_decode(worst_adv):
            return  # every running request was shed for blocks
        self._patch_slot_state()
        active = list(self._running)
        snapshot = list(self._running.items())
        top = int(self._positions[active].max())
        # A constrained slot running: the call is the constrained plain
        # call and no speculative call is made (JAX :4865-4871; the verify
        # block is not masked). With none running, today's call.
        st_on = any(r.fsm is not None for r in self._running.values())
        if self.spec_draft and not st_on and self._spec_call_wanted():
            # The KV bucket holds the EMA-expected advance and at least one
            # whole verify block past every slot's position: with less, the
            # in-call gate (pos + T <= kv_len) would mask every step and
            # the same empty call would be dispatched forever (JAX
            # :4865-4890). Underestimates are safe: a slot without room
            # sits the step out and gives n_out = 0.
            exp_adv = int(steps * min(float(t), max(1.0, self._spec_ema)
                                      + 1.0))
            need = top + sum(c.advance for c in self._inflight) \
                + max(exp_adv, t)
            if need <= self.max_len:
                # sp > 1 attends the whole sharded cache (JAX :1856-1864).
                kv_len = self.max_len if self._sp > 1 \
                    else _kv_bucket(need, self.max_len)
                t0 = time.perf_counter()
                m0 = self._dev_mark()
                toks = self._call("spec", kv_len=kv_len, steps=steps)
                marks = None if m0 is None else (m0, self._devclock.mark())
                dt = time.perf_counter() - t0
                self.decode_host_s += dt
                self.spec_host_s += dt
                self.decode_calls += 1
                self.decode_steps += steps
                self.spec_calls += 1
                self.spec_steps += steps
                if any(r.fsm is not None for _, r in snapshot):
                    self.spec_constrained_calls += 1
                # Promise the EMA-expected tokens: promising ``steps``
                # would queue up to T times too many calls.
                self._inflight.append(_Call(
                    _HostCopy(toks),
                    promise=steps * min(float(t), max(1.0, self._spec_ema)),
                    advance=exp_adv, max_advance=worst_adv,
                    snapshot=snapshot, marks=marks,
                    program=program_key("spec_decode", kv_len=kv_len,
                                        steps=steps),
                    kv_len=kv_len))
                return
        # A plain step emits a token for every slot, so its bucket must hold
        # the most the calls ahead of it can advance.
        kv_len = self.max_len if self._sp > 1 else _kv_bucket(
            top + sum(c.max_advance for c in self._inflight) + steps,
            self.max_len)
        tables = self._st_call_tables() if st_on else None
        t0 = time.perf_counter()
        m0 = self._dev_mark()
        # The FSM tables ride only single-rank calls (structured decoding
        # is unavailable on a mesh).
        toks = self._call("decode", kv_len=kv_len, steps=steps,
                          **({"fsm": tables} if st_on else {}))
        marks = None if m0 is None else (m0, self._devclock.mark())
        dt = time.perf_counter() - t0
        self.decode_host_s += dt
        self.decode_calls += 1
        self.decode_steps += steps
        if st_on:
            self.structured_host_s += dt
            self.structured_calls += 1
            self.structured_steps += steps
        self._inflight.append(_Call(
            _HostCopy(toks), promise=steps, advance=steps, max_advance=steps,
            snapshot=snapshot, tables=tables, marks=marks,
            program=self._decode_program(kv_len, steps, st_on),
            kv_len=kv_len))

    def _decode_table(self, kv_len: int) -> torch.Tensor | None:
        return (self._paged_table(kv_len // self.kv_block_size,
                                  list(range(self.num_slots)))
                if self.paged else None)

    def _retire_oldest(self) -> None:
        """Wait for the oldest in-flight call and consume its tokens. A
        speculative call's [K, S, T + 1] rows give their first ``n_out``
        tokens (the last column)."""
        call = self._inflight.popleft()
        if _fp.enabled:
            # Chaos seam: `hang` here is the wedged device call; the
            # heartbeat goes stale and the watchdog must force_fail the
            # stalled requests.
            _fp.fire("engine.retire.fetch")
        snapshot = call.snapshot
        gen_before = ({id(req): req.generated for _, req in snapshot}
                      if call.marks is not None else {})
        if any(req.first_pending for _, req in snapshot):
            self._drain_firsts(block=True)
        t0 = time.monotonic()
        res = call.copy.result()
        self._j_wait0 = t0
        self._j_fetched = time.monotonic()
        self._m_step.observe((self._j_fetched - t0) * 1000)
        if self._pending_firsts:
            self._drain_firsts(block=False)
        consumed = 0  # tokens fed to requests (the step record's tokens)
        for k in range(res.shape[0]):
            for s, req in snapshot:
                if req.finished or self._running.get(s) is not req:
                    continue  # ended earlier, or the slot was re-admitted
                if res.ndim == 2:
                    self._positions[s] += 1
                    consumed += 1
                    self._consume_token(req, int(res[k, s]))
                    continue
                n = int(res[k, s, -1])
                if n:
                    self._m_spec.observe(n)
                    self._spec_ema = 0.9 * self._spec_ema + 0.1 * n
                    req.spec_accepted += n - 1
                    req.spec_drafted += self.spec_draft
                    self.spec_accepted += n - 1
                    self.spec_drafted += self.spec_draft
                    self.spec_blocks += 1
                for i in range(n):
                    if req.finished or self._running.get(s) is not req:
                        break
                    self._positions[s] += 1
                    consumed += 1
                    self._consume_token(req, int(res[k, s, i]))
        for _, req in snapshot:
            self._flush_emit(req)
        if call.marks is not None:
            self._record_step(call, res, consumed, gen_before)
        self._flush_dev_records()

    def _record_step(self, call: _Call, res: np.ndarray, consumed: int,
                     gen_before: dict[int, int]) -> None:
        """One ``engine_step`` record for a retired call over its device
        span (the host copy waited on the stream past its end mark) and
        one ``decode_step`` span per request in it (JAX :5067-5115):
        batch occupancy at dispatch, the rows the call computed, the
        tokens consumed, and the FLOPs, KV bytes and weight bytes read."""
        clock, snapshot = self._devclock, call.snapshot
        t0, t1 = (clock.to_monotonic(m) for m in call.marks)
        spec = res.ndim == 3
        steps = int(res.shape[0])
        constrained = sum(1 for _, r in snapshot if r.fsm is not None)
        occupancy = round(len(snapshot) / max(1, self.num_slots), 3)
        rows = steps * self.num_slots * (res.shape[2] - 1 if spec else 1)
        self._tracer.step(
            "engine_step", t0, t1, steps=steps, batch=len(snapshot),
            slots=self.num_slots, occupancy=occupancy,
            kind="spec" if spec else "plain", program=call.program,
            tokens=consumed, rows=rows, kv_len=call.kv_len,
            flops=self._perf.call_flops(consumed, call.kv_len),
            kv_bytes=steps * self._kv_read_rows(snapshot, call.kv_len)
            * self._kv_row_bytes,
            weight_bytes=steps * self._weight_bytes_per_step,
            **({"constrained": constrained} if constrained else {}))
        for s, req in snapshot:
            self._tracer.add_span(
                req.request_id, "decode_step", t0, t1, slot=s,
                batch=len(snapshot), occupancy=occupancy,
                tokens=req.generated - gen_before.get(id(req), 0),
                kind="spec" if spec else "plain")

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
        if req.fsm is not None:
            # Host mirror of the device FSM advance; _finish, the terminal
            # check and jump-forward read it.
            req.fsm_state = req.fsm.step(req.fsm_state, token_id)
        self.tokens_generated += 1
        self._m_tokens.inc()
        now = time.monotonic()
        if req.last_token_at is not None:
            gap_ms = (now - req.last_token_at) * 1000
            self._m_intertok.observe(gap_ms)
            if gap_ms > req.max_gap_ms:
                req.max_gap_ms = gap_ms  # the SLO's inter-token SLI
        req.last_token_at = now
        if req.first_token_at is None:
            req.first_token_at = now
            self._m_ttft.observe(
                (req.first_token_at - req.submitted_at) * 1000)
            self._tracer.event(req.request_id, "first_token")
        t_detok = time.monotonic()
        delta = req.detok.push(token_id)
        req.detok_s += time.monotonic() - t_detok
        if delta:
            self._stream_text(req, delta)
        if req.finished:
            return  # stop string hit inside _stream_text
        if req.fsm is not None and req.fsm.is_terminal(req.fsm_state):
            # The document is complete (an accept state whose only
            # continuation is EOS): "stop" now, before the budget check,
            # and without a decode step for the EOS itself.
            self._finish(req, "stop")
            return
        if req.generated >= req.params.max_tokens \
                or len(slot.tokens) >= self.usable_len:
            self._finish(req, "length")
        elif req.fsm is not None:
            self._st_note_jump_candidate(req)

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
        if req.admitted_at is not None:
            # Admission-to-finish time feeds the scheduler's service-time
            # EMA (wait estimates, retry_after).
            self._sched.note_service_time(time.monotonic() - req.admitted_at)
        if reason != "cancelled":
            # Cancels are the client's choice, not an SLO sample; sheds
            # (deadline expiry, block exhaustion) count as sheds, not
            # errors (JAX :5217-5236).
            if code in ENGINE_SHED_CODES and error is not None:
                with self._term_lock:
                    already = req.slo_recorded
                    req.slo_recorded = True
                if not already:
                    self._slo.record_shed(req.params.priority)
            else:
                self._record_slo(req, ok=error is None)
        if req.fsm is not None:
            self._st_release(req)
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
                # The finished turn's full blocks below kv_written go to
                # the radix tree now, before a deferred release drops the
                # table. Late writes of the calls in flight land at or
                # past kv_written (the host mirror lags the device), so
                # none reaches a donated block (JAX :5258-5271).
                self._radix_insert_slot(slot)
            sid = slot.session_id
            if sid is not None and sid in self._release_after:
                self._release_after.discard(sid)
                self.slots.release_session(sid)
                self._kv_pool.purge(sid)
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
        if self._tracer.enabled:
            self._trace_finish(req, reason)
        if error is not None:
            event = {"type": "error", "error": error, "code": code}
            if retry_after is not None:
                event["retry_after"] = retry_after
            self._emit(req, event)
            return
        duration = time.monotonic() - req.submitted_at
        ttft_ms = ((req.first_token_at or time.monotonic())
                   - req.submitted_at) * 1000
        stats = {
            "tokens_generated": req.generated,
            "processing_time_ms": duration * 1000,
            "tokens_per_second": (req.generated / duration
                                  if duration > 0 else 0.0),
            "ttft_ms": ttft_ms,
            "prompt_tokens": len(req.prompt_tokens),
            "prefill_tokens": req.prefill_tokens,
        }
        if req.spec_drafted:
            stats["spec_accepted"] = req.spec_accepted
            stats["spec_drafted"] = req.spec_drafted
        self._emit(req, {
            "type": "cancelled" if reason == "cancelled" else "done",
            "finish_reason": reason, "stats": stats})

    def _trace_finish(self, req: _Request, reason: str) -> None:
        """The request's summary spans at its end (JAX :5293-5327)."""
        now = time.monotonic()
        if req.admitted_at is None:
            # Never admitted: the whole lifetime was queue wait.
            self._tracer.add_span(req.request_id, "queue_wait",
                                  req.submitted_at, now, summary=True)
        if req.decode_started_at is not None:
            attrs: dict[str, Any] = {
                "tokens": req.generated, "finish_reason": reason,
                "prompt_tokens": len(req.prompt_tokens)}
            if req.spec_drafted:
                attrs["spec_accepted"] = req.spec_accepted
                attrs["spec_rejected"] = req.spec_drafted - req.spec_accepted
            if req.fsm is not None:
                attrs["structured"] = True
                attrs["jump_tokens"] = req.jump_tokens
            self._tracer.add_span(req.request_id, "decode",
                                  req.decode_started_at, now,
                                  summary=True, **attrs)
        if req.detok_s > 0:
            # One aggregate span of the detokenize time, ending at finish.
            self._tracer.add_span(req.request_id, "detokenize",
                                  now - req.detok_s, now, summary=True,
                                  aggregate=True)
        self._tracer.set_phase(req.request_id, "finishing")

    def _flush_emit(self, req: _Request) -> None:
        """Send the text batched during one retirement as one token event;
        with ``journey`` it carries the retirement's fetch-wait start, the
        fetch landing and the enqueue instant (JAX :5353-5372)."""
        if req.emit_buf:
            text, req.emit_buf = req.emit_buf, ""
            event: dict = {"type": "token", "text": text}
            if req.params.journey:
                event["j"] = {"w": self._j_wait0, "f": self._j_fetched,
                              "e": time.monotonic()}
            self._emit(req, event)

    def _emit(self, req: _Request, event: dict) -> None:
        try:
            req.loop.call_soon_threadsafe(req.out_queue.put_nowait, event)
        except RuntimeError:
            pass  # client loop already closed; drop

    # ---------------- structured decoding ----------------
    # (JAX engine.py :3212-3465. Engine thread only, but the compiler.)

    def _get_st_compiler(self) -> FSMCompiler:
        """The FSM compiler, built at the first constrained request (it
        scans the vocabulary once, on its own worker thread)."""
        if self._st_compiler is None:
            with self._st_compiler_lock:
                if self._st_compiler is None:
                    self._st_compiler = FSMCompiler(
                        self.tokenizer,
                        cache_size=self._st_cfg["cache_size"],
                        max_states=self._st_cfg["max_states"],
                        json_depth=self._st_cfg["json_depth"],
                        sample_vocab=self.sample_vocab)
        return self._st_compiler

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A small host array on the device without waiting for the stream
        (pinned memory on CUDA)."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _st_register(self, req: _Request) -> None:
        """Pin a constrained request's FSM into the union arena. A grown
        arena repacks state offsets: with constrained calls in flight the
        pipeline is drained first, so the host mirrors are authoritative,
        then the tables are uploaded and every running constrained slot's
        device state is refreshed. Raises ArenaFull when running requests
        pin the whole budget."""
        if self._st_arena is None:
            self._st_arena = FSMArena(
                self.sample_vocab,
                tuple(sorted(t for t in self.tokenizer.eos_ids
                             if 0 <= t < self.sample_vocab)),
                self.num_slots, state_budget=self._st_cfg["state_budget"])
        arena = self._st_arena
        req.fsm_entry = arena.register(req.fsm)
        if not arena.dirty:
            return
        if any(r.fsm is not None for call in self._inflight
               for _, r in call.snapshot):
            while self._inflight:
                self._retire_oldest()
        if any(r.fsm is not None for _, ents in self._pending_firsts
               for _, _, r in ents):
            self._drain_firsts(block=True)
        self._st_upload_tables()
        for s, r in self._running.items():
            if r.fsm is not None and r.fsm_entry is not None:
                self._st_sel[s] = r.fsm_entry.sel
                self._st_dirty.add(s)
        self._st_sel_dev = None

    def _st_upload_tables(self) -> None:
        """The arena's tables onto the device. Calls in flight keep the
        previous tables alive through their ``_Call``."""
        arena = self._st_arena
        self._st_tables = FSMTables.upload(arena.masks, arena.nexts,
                                           arena.cls, None, self.device)
        arena.dirty = False

    def _st_call_tables(self) -> FSMTables:
        """The tables of one constrained call, with the slots' selector
        rows uploaded when they changed."""
        if self._st_sel_dev is None:
            self._st_sel_dev = self._upload(self._st_sel.copy())
        return replace(self._st_tables, sel=self._st_sel_dev)

    def _st_release(self, req: _Request) -> None:
        """Terminal-path cleanup of a constrained request: unpin the FSM
        (its tables stay cached for the next request of the schema) and put
        the slot's device state back to FREE."""
        self._st_jf_pending.discard(req.request_id)
        if req.fsm_entry is not None and self._st_arena is not None:
            self._st_arena.release(req.fsm)
            req.fsm_entry = None
        slot = req.slot
        if slot is not None:
            self._st_sel[slot.index] = 0
            self._st_sel_dev = None
            self._st_dirty.add(slot.index)

    def _st_global_state(self, slot_index: int) -> int:
        req = self._running.get(slot_index)
        if req is None or req.fsm is None or req.fsm_entry is None:
            return 0  # FREE
        return self._st_arena.global_state(req.fsm_entry, req.fsm_state)

    def _st_sample_place(self, req: _Request, slot: Slot,
                         last_logits: torch.Tensor) -> None:
        """Sample a constrained slot's next token under the allowed row of
        its current FSM state (after a prefill or a jump), place it as the
        slot's current token and advance the slot's device state, all on
        the device; the token is emitted when its copy lands."""
        entry = req.fsm_entry
        gstate = self._st_arena.global_state(entry, req.fsm_state)
        row = pack_mask_row(req.fsm, req.fsm_state, self._st_arena.words,
                            req.fsm.eos_ids)
        t = self._st_tables
        m0 = self._dev_mark()
        allow = unpack_mask(self._upload(row.view(np.int32)), t.powers,
                            self.sample_vocab)
        lg = last_logits[:self.sample_vocab].to(torch.float32)
        lg = torch.where(allow, lg, torch.full_like(lg, -1e30))
        first = sample_tokens(
            lg[None], self._dev.gen,
            self._dev_scalar(req.params.temperature, torch.float32),
            self._dev_scalar(req.params.top_k, torch.int64),
            self._dev_scalar(req.params.top_p, torch.float32),
            method=self.sampling_method)
        self._dev.cur[slot.index] = first[0]
        self._dev.fst[slot.index] = t.nexts[gstate, t.cls[entry.sel,
                                                          first[0]]]
        self._dev_record("engine_op", m0, kind="st_sample",
                         program=program_key("st_sample"))
        # This wrote the slot's authoritative state (after the first
        # token). A patch queued for the slot's previous occupant (its
        # finish -> FREE) would now rewind the device FSM by one token,
        # since the host mirror lags until the first token's copy lands:
        # drop it.
        self._st_dirty.discard(slot.index)
        self._defer_first(first, [(0, slot.index, req)])

    def _st_penalties_neutral(self, req: _Request) -> bool:
        p = req.params
        return (p.repeat_penalty == 1.0 and p.presence_penalty == 0.0
                and p.frequency_penalty == 0.0)

    def _st_note_jump_candidate(self, req: _Request) -> None:
        """After each consumed token of a constrained request: queue a jump
        when its state opens a forced chain of at least
        ``STRUCTURED_JF_MIN`` tokens. Jumps need neutral penalties (forced
        tokens bypass the device counts); with penalties the decode steps
        emit the same forced tokens one step each."""
        if self._st_jf_min <= 0 or not self._st_penalties_neutral(req):
            return
        if req.fsm_state < 0 or int(req.fsm.forced_tok[req.fsm_state]) < 0:
            return  # DONE/DEAD sentinel, or not a forced state
        chain, _ = req.fsm.forced_chain(req.fsm_state)
        if len(chain) >= self._st_jf_min:
            self._st_jf_pending.add(req.request_id)

    def _st_jump_forward(self) -> None:
        """Emit each pending forced chain without decode steps: one prefill
        of the newest (unfed) token plus the chain writes their KV rows,
        the chain streams at once, and a masked sample from the chain-end
        state (the prefill's last logits) restarts decoding. Runs with the
        pipeline empty, so no call in flight can emit the chain twice."""
        self._drain_firsts(block=True)
        pending, self._st_jf_pending = self._st_jf_pending, set()
        for rid in pending:
            req = self._by_id.get(rid)
            if req is None or req.finished or req.slot is None:
                continue
            slot = req.slot
            if self._running.get(slot.index) is not req:
                continue
            chain, _end = req.fsm.forced_chain(req.fsm_state)
            room = min(req.params.max_tokens - req.generated,
                       self.usable_len - len(slot.tokens) - 1,
                       self.prefill_chunk - 1)
            n = min(len(chain), room)
            if n < self._st_jf_min:
                continue
            chain = chain[:n]
            start = int(self._positions[slot.index])
            feed = [slot.tokens[-1]] + chain
            bucket = next((b for b in _PREFILL_BUCKETS if b >= len(feed)),
                          None)
            if bucket is None or start + bucket > self.max_len:
                continue  # no room: the decode steps emit the chain
            if self.paged and not self._kv_blocks.ensure(slot.index,
                                                         start + bucket):
                continue  # no blocks: the decode steps emit the chain
            t0 = time.monotonic()
            m0 = self._dev_mark()
            last_logits = self._run_chunk_prefill(slot, feed, start, bucket)
            self._dev_record("engine_prefill", m0, bucket=bucket,
                             tokens=len(feed), rows=bucket,
                             kind="jump_forward",
                             program=self._prefill_program(start, bucket),
                             flops=self._perf.call_flops(len(feed),
                                                         start + n))
            self._positions[slot.index] = start + n + 1
            slot.kv_written = start + n + 1
            self._dirty_slots.add(slot.index)
            for tok in chain:
                if req.finished or self._running.get(slot.index) is not req:
                    break
                self._consume_token(req, tok)
                req.jump_tokens += 1
                self.structured_jump_tokens += 1
                self._m_st_jump.inc()
            self._flush_emit(req)
            if self._tracer.enabled:
                self._tracer.add_span(req.request_id, "jump_forward", t0,
                                      time.monotonic(), tokens=n)
            if req.finished:
                continue
            self._st_sample_place(req, slot, last_logits)

    # ---------------- paged KV tier ----------------
    # (KV_LAYOUT=paged; JAX engine.py :2826-3206. Engine thread only.)

    def _on_slot_unpin(self, slot: Slot) -> None:
        """SlotManager hook: a session leaving its slot (eviction or
        release) drops its whole block table; aliased blocks live on
        through their other referents. With the radix cache on, the
        session's clean prefix blocks are donated to the tree first."""
        if self.paged:
            self._radix_insert_slot(slot)
            self._kv_blocks.release(slot.index)

    def _paged_copy_block(self, src_blk: int, dst_blk: int) -> None:
        """Copy one block's rows of every layer (and their scale rows on
        the int8 tier) to another block: the copy-on-write primitive (JAX
        ``kv_block_copy`` :2898-2953), a tensor copy on the stream."""
        bs = self.kv_block_size
        src = slice(src_blk * bs, (src_blk + 1) * bs)
        dst = slice(dst_blk * bs, (dst_blk + 1) * bs)
        m0 = self._dev_mark()
        for pool in self.cache:
            if pool is not None:
                pool[:, dst] = pool[:, src]
        self._dev_record("engine_op", m0, kind="kv_block_copy",
                         program=program_key("kv_block_copy", block_size=bs,
                                             **self._kvq_attrs))

    def _paged_sync_resident(self, slot: Slot) -> None:
        """Reconcile the slot's table with its (possibly just truncated)
        trusted rows: drop blocks past kv_written, and copy the tail block
        on write when it is shared and the next write would land inside it
        (JAX :2955-2976). With the pool empty the slot falls back to the
        block boundary and the dropped tail rows prefill again."""
        alloc = self._kv_blocks
        kvw = slot.kv_written
        alloc.truncate(slot.index, kvw)
        tail = kvw % self.kv_block_size
        if tail and alloc.tail_shared(slot.index):
            pair = alloc.cow_tail(slot.index)
            if pair is None:
                aligned = kvw - tail
                slot.tokens = slot.tokens[:aligned]
                slot.kv_written = aligned
                alloc.truncate(slot.index, aligned)
                return
            self._paged_copy_block(*pair)

    def _paged_alias(self, src: Slot, slot: Slot, share: int) -> int:
        """The paged shared-prefix stamp: alias the source's full blocks
        into this fresh slot's table (refcounts, no row copy) and copy the
        partially shared tail block (JAX :2978-2998). Returns the prompt
        tokens now resident."""
        if share < self._STAMP_GRANULE:
            return 0
        bs = self.kv_block_size
        alloc = self._kv_blocks
        full, tail = divmod(share, bs)
        n = alloc.alias(src.index, slot.index, full) if full else 0
        reused = n * bs
        if n == full and tail:
            blk = alloc.append_block(slot.index)
            if blk is not None:
                self._paged_copy_block(alloc.table(src.index)[full], blk)
                alloc.cow_copies += 1
                reused += tail
        return reused

    # ---------------- radix prefix cache ----------------
    # (kvcache/radix.py; JAX engine.py :3003-3068. Engine thread only.)

    def _radix_insert_slot(self, slot: Slot) -> int:
        """Donate a slot's fully written prefix blocks to the radix tree
        (allocator holds on the blocks it did not cache yet)."""
        tree = self._kv_radix
        if tree is None or slot.session_id is None:
            return 0
        kept = min(slot.kv_written, len(slot.tokens))
        if kept < self.kv_block_size:
            return 0
        return tree.insert(slot.tokens, self._kv_blocks.table(slot.index),
                           written=kept)

    def _radix_admit(self, req: _Request, slot: Slot,
                     prompt: list[int]) -> int:
        """Alias the longest radix-cached block chain into this fresh
        slot; the delta prefills from a block boundary. On a short match
        another slot's longer resident prefix seeds the tree first. A
        longer parked host entry of this session wins (0 returned, the
        restore runs next). Returns the prompt tokens now resident."""
        tree = self._kv_radix
        if tree is None:
            return 0
        bs = self.kv_block_size
        # At least one prompt token must run through the model.
        max_blocks = (len(prompt) - 1) // bs
        if max_blocks <= 0:
            return 0
        blocks, _digest = tree.match(prompt, max_blocks=max_blocks)
        matched = len(blocks) * bs
        if self.shared_prefix and matched < max_blocks * bs:
            src, share = self.slots.best_shared_prefix(slot, prompt)
            if src is not None \
                    and min(share, src.kv_written) // bs * bs > matched:
                self._radix_insert_slot(src)
                blocks, _digest = tree.match(prompt, max_blocks=max_blocks,
                                             count=False)
                matched = len(blocks) * bs
        if matched < bs:
            return 0
        if self._kv_pool.enabled:
            entry = self._kv_pool.get(req.session_id)
            if entry is not None:
                hm = _lcp(entry.tokens, prompt,
                          min(entry.kept, len(prompt) - 1))
                if hm > matched and self._kv_policy.should_restore(
                        hm, entry.nbytes):
                    return 0
        self._kv_blocks.alias_blocks(slot.index, blocks)
        slot.tokens = list(prompt[:matched])
        slot.kv_written = matched
        tree.note_hit(matched)
        self._count_shared(matched)
        return matched

    # ---------------- host KV offload ----------------
    # (kvcache/offload.py; JAX engine.py :2477-2721. Engine thread only,
    # but _kv_wait_discount.)

    def _park_on_evict(self, victim: Slot) -> None:
        """SlotManager eviction hook (inside ``acquire``): snapshot the
        victim's kept rows before the slot is cleared for its new session.
        The snapshot is enqueued on the stream here, before anything of the
        new occupant; the host copy runs on the offload thread."""
        if not self._kv_pool.enabled:
            return
        kept = min(victim.kv_written, len(victim.tokens))
        if kept < self._kv_policy.min_tokens:
            return
        if self._kv_pool.parked_len(victim.session_id) >= kept \
                or self._kv_offload.parking(victim.session_id):
            return  # an up-to-date snapshot is parked or in flight
        self._park_slot(victim, kept)

    def _park_slot(self, slot: Slot, kept: int) -> None:
        """Snapshot ``kept`` rows of the slot on the device and hand them
        to the offload thread. Dense: the JAX bucket of rows; paged: the
        slot's whole blocks covering ``kept`` (exact per-block bytes)."""
        t0 = time.monotonic()
        m0 = self._dev_mark()
        bucket = kv_bucket(kept, self.max_len)
        if self.paged:
            bucket = max(bucket, self.kv_block_size)
            rows = paged_kv_slice(self.cache, self._paged_read_indices(
                slot.index, blocks_for(kept, self.kv_block_size)
                * self.kv_block_size))
        else:
            rows = kv_slice(self.cache, slot.index, bucket)
        self._dev_record("engine_op", m0, kind="kv_offload",
                         program=program_key(
                             "kv_offload", bucket=bucket, **self._kvq_attrs,
                             **({"kv_layout": "paged"} if self.paged
                                else {})))
        self._kv_offload.park(slot.session_id, list(slot.tokens[:kept]),
                              kept, bucket, rows, t0)

    def _prefill_park_finish(self, req: _Request, slot: Slot) -> None:
        """Terminal step of a ``prefill_only`` request: snapshot the freshly
        written prompt rows into the host pool and finish with reason
        ``prefill_parked``: no first-token sample, no activation, the slot
        frees at once. The host copy runs on the offload thread; the router
        polls ``parked_kv_info`` until the entry lands (JAX :2531-2545)."""
        kept = min(slot.kv_written, len(slot.tokens))
        if kept >= 1 and self._kv_pool.enabled \
                and self._kv_pool.parked_len(req.session_id) < kept \
                and not self._kv_offload.parking(req.session_id):
            self._park_slot(slot, kept)
        self._finish(req, "prefill_parked")

    def _try_restore(self, req: _Request, slot: Slot,
                     prompt: list[int]) -> int:
        """Restore a returning session's kept prefix from the host pool
        into its fresh slot (JAX :2546-2677). Returns the leading prompt
        tokens now resident (0: no entry, or the policy chose prefill). A
        failed restore purges the entry, empties the slot's table again
        and falls back to a full prefill."""
        if not self._kv_pool.enabled:
            return 0
        entry = self._kv_pool.get(req.session_id)
        if entry is None:
            self._kv_pool.note_lookup(False)
            return 0
        # Only the matched prefix is trusted, and one prompt token at least
        # must run through the model.
        match = _lcp(entry.tokens, prompt, min(entry.kept, len(prompt) - 1))
        if not self._kv_policy.should_restore(match, entry.nbytes) \
                or (self.kv_quant and entry.k_scale is None):
            self._kv_pool.note_lookup(False)
            return 0  # the entry stays parked for a later, longer match
        if self.paged and not self._kv_blocks.ensure(slot.index, match):
            self._kv_pool.note_lookup(False)
            return 0
        t0 = time.monotonic()
        m0 = self._dev_mark()
        prestaged = entry.k_dev is not None
        try:
            if _fp.enabled:
                _fp.fire("kv.restore.dispatch", request_id=req.request_id,
                         session_id=req.session_id)
            rows = upload(entry, self.device)
            if self.paged:
                # Only the rows of the blocks ensure() gave the slot.
                n = blocks_for(match, self.kv_block_size) * self.kv_block_size
                paged_kv_restore(self.cache, rows,
                                 self._paged_read_indices(slot.index, n))
            else:
                kv_restore(self.cache, rows, slot.index)
        except Exception as e:
            log.error(f"kv restore failed for {req.session_id}: {e}; "
                      "falling back to full prefill")
            self.kv_restore_failed += 1
            if self.paged:
                # The slot's table must be empty again before a
                # shared-prefix alias, which requires a fresh table.
                self._kv_blocks.truncate(slot.index, slot.kv_written)
            self._kv_pool.purge(req.session_id)
            self._kv_pool.note_lookup(False)
            return 0
        slot.tokens = list(entry.tokens[:match])
        slot.kv_written = match
        if entry.imported:
            # A migrated-in prefix (handoff or fleet migration) goes to
            # the radix tree now, while this slot's table pins its blocks:
            # the decode tier's prefix cache learns handed-off prefills at
            # first use (JAX :2652-2660).
            self._radix_insert_slot(slot)
        # Consumed: the rows are on the device again; a later eviction
        # parks the longer history.
        self._kv_pool.take(req.session_id)
        self._kv_pool.note_lookup(True)
        self._kv_offload.note_restore(time.monotonic() - t0)
        if self._tracer.enabled:
            self._tracer.add_span(req.request_id, "kv_restore", t0,
                                  time.monotonic(), tokens=match,
                                  bytes=entry.nbytes, prestaged=prestaged)
        self._dev_record("engine_op", m0, kind="kv_restore",
                         program=program_key(
                             "kv_restore", bucket=entry.bucket,
                             **self._kvq_attrs,
                             **({"kv_layout": "paged"} if self.paged
                                else {})))
        log.debug(f"restored {match} rows of {req.session_id} "
                  f"({entry.nbytes} bytes, prestaged={prestaged})")
        return match

    def _kv_wait_discount(self, session_id: str,
                          prompt: list[int]) -> float:
        """Seconds a restore would save this request (asyncio side; the
        entry's token list is immutable, so the LCP runs outside the pool
        lock)."""
        if not self._kv_pool.enabled:
            return 0.0
        entry = self._kv_pool.get(session_id)
        if entry is None:
            return 0.0
        match = _lcp(entry.tokens, prompt, min(entry.kept, len(prompt) - 1))
        return self._kv_policy.restore_saving_s(match, entry.nbytes)

    def _kv_tick(self) -> None:
        """Once a second: the pool's TTL sweep, and a park of every
        pinned session idle past KV_PARK_IDLE_S (the slot stays pinned;
        the host copy makes a later eviction free)."""
        if not self._kv_pool.enabled:
            return
        now = time.monotonic()
        if now - self._kv_last_tick < 1.0:
            return
        self._kv_last_tick = now
        self._kv_pool.sweep(now)
        if self._kv_park_idle_s <= 0:
            return
        for slot in self.slots.slots:
            if slot.session_id is None or slot.active:
                continue
            kept = min(slot.kv_written, len(slot.tokens))
            if kept < self._kv_policy.min_tokens \
                    or now - slot.last_used < self._kv_park_idle_s:
                continue
            if self._kv_pool.parked_len(slot.session_id) >= kept \
                    or self._kv_offload.parking(slot.session_id):
                continue
            self._park_slot(slot, kept)

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
        avail = self._kv_blocks.available()
        if self._kv_radix is not None:
            # Blocks only the tree holds are reclaimed on demand (the
            # allocator's pressure callback), so they count as free.
            avail += self._kv_radix.evictable_blocks()
        if need <= avail:
            return True
        self._paged_exhausted_finish(
            req, f"KV block pool exhausted: prompt needs {need} more "
                 f"{bs}-token blocks ({self._kv_blocks.available()} free of "
                 f"{self.kv_pool_blocks})")
        return False

    def _paged_retry_after(self) -> float:
        """Back-off of a block shed: about one service time must pass for
        a running generation to finish and free its blocks."""
        ema = self._sched.stats().get("service_time_ema_s") or 0.0
        return round(max(0.5, float(ema)), 2)

    def _paged_wait_penalty(self, prompt_len: int) -> float:
        """The block-pressure term of the scheduler's wait estimate (asyncio
        side; a racy read is fine for an estimate): when the pool cannot
        hold this prompt now, a running generation must finish first."""
        if not self.paged:
            return 0.0
        avail = self._kv_blocks.available()
        if self._kv_radix is not None:
            try:
                avail += self._kv_radix.evictable_blocks()
            except RuntimeError:
                pass  # the engine thread changed the tree mid-walk
        if blocks_for(prompt_len, self.kv_block_size) <= avail:
            return 0.0
        return self._paged_retry_after()

    def _paged_exhausted_finish(self, req: _Request, error: str) -> None:
        """End a request for want of blocks, as load shedding."""
        self._finish(req, "error", error=error, code="kv_blocks_exhausted",
                     retry_after=self._paged_retry_after())

    def _paged_prepare_decode(self, worst_adv: int) -> bool:
        """Ensure every running slot's blocks out to the worst-case write
        horizon of the next decode call: its host position plus the most
        the in-flight calls and this one (``worst_adv``: steps x verify
        block) can advance. On exhaustion, shed the most recently admitted
        request (its session is released, so its blocks free) and retry.
        Returns False when nothing is left to run."""
        lead = sum(c.max_advance for c in self._inflight) + worst_adv
        while self._running:
            victim: _Request | None = None
            for s in self._running:
                horizon = min(self.max_len, int(self._positions[s]) + lead)
                if not self._kv_blocks.ensure(s, horizon):
                    victim = max(self._running.values(),
                                 key=lambda r: r.admitted_at or 0.0)
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
                self._kv_pool.purge(slot.session_id)
        return False
