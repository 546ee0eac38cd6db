"""Environment-driven configuration of the port's serving slice.

The subset of ``fasttalk_tpu/utils/config.py`` that the WebSocket serving
path reads, under the same environment names, defaults and validation
(the KV tiers: ``fasttalk_tpu/utils/config.py`` :535-589, :1083-1141).
The weight tiers (``WEIGHT_QUANT`` off|int8|int4 and its legacy alias
``TPU_QUANTIZE``, ``WEIGHT_QUANT_GROUP``, ``WEIGHT_QUANT_CALIB``,
``TPU_USE_PALLAS_INT4``) resolve and fail as in
``fasttalk_tpu/utils/config.py`` :337-358, :818-829, :931-965.
``WEIGHT_QUANT_CALIB`` is read by ``python -m fasttalk_tpu_torch
quantize`` only. ``TPU_USE_PALLAS_INT4`` is an accepted, validated name and
a no-op: on the port the hand-written ``int4_matmul`` kernel is the int4
decode path on the card, as ``decode_attend`` is the decode attention path
whatever ``TPU_USE_PALLAS_ATTENTION`` says in the JAX package.
The engine defaults of the JAX serving path are read under the same names,
defaults and messages: ``TPU_SAMPLING`` (fast|exact), ``TPU_SHARED_PREFIX``,
``TPU_SPEC_DECODE`` (off|ngram|auto, default auto), ``TPU_SPEC_DRAFT``,
``TPU_SPEC_BREAKEVEN`` and the admission scheduler's ``SCHED_QUEUE_BOUND``,
``SCHED_DEADLINE_S``, ``SCHED_DEFAULT_PRIORITY``, ``SCHED_AGING_S`` and
``SCHED_DRAIN_TIMEOUT_S`` (``fasttalk_tpu/utils/config.py`` :289-323,
:366-389, :909-921, :966-976, :1104-1109; spec decoding with
``KV_QUANT=int8`` is the same named startup error).
Structured decoding reads ``STRUCTURED_MODE`` (auto|on|off),
``STRUCTURED_MAX_STATES``, ``STRUCTURED_STATE_BUDGET``,
``STRUCTURED_JF_MIN``, ``STRUCTURED_CACHE`` and ``STRUCTURED_JSON_DEPTH``
under the same names, defaults and messages (``fasttalk_tpu/utils/
config.py`` :613-649, :1161-1181).
The session host-offload tier (``KV_HOST_BUDGET_MB``, ``KV_PARK_TTL_S``,
``KV_PARK_IDLE_S``, ``KV_RESTORE_MIN_TOKENS``) and the radix prefix cache
(``KV_RADIX_ENABLED``, ``KV_RADIX_MIN_BLOCKS``, ``KV_RADIX_EVICT_POLICY``)
resolve and fail as in ``fasttalk_tpu/utils/config.py`` :519-534,
:599-611, :1073-1082, :1144-1160, :1200-1214.
The observability settings (``LLM_MONITORING_PORT``/``_HOST``, ``SLO_*``,
``WATCHDOG_*``, ``METRICS_WINDOW_S``, ``PERF_*``, ``PROF_*``, ``FLIGHT_*``
and ``JOURNEY_*``) have the JAX names, defaults and messages
(``fasttalk_tpu/utils/config.py`` :650-780, :1217-1276), but for
``FLIGHT_DIR``, whose default is the port's own directory; the
observability singletons read the same names at construction.
The lifecycle settings have the JAX names, defaults and messages
(``fasttalk_tpu/utils/config.py`` :111-142, :184-211, :394-399, :808-817,
:836-837, :889-904, :1277-1278): ``LLM_PROVIDER`` (``tpu`` names the
in-tree engine), the ``VLLM_*``, ``OLLAMA_*`` and ``REMOTE_*`` settings of
the remote providers, the agent's ``ENABLE_PYDANTIC_AI``, ``ENABLE_TOOLS``,
``ENABLE_WEB_SEARCH``, ``DUCKDUCKGO_RATE_LIMIT`` and ``WEB_SEARCH_*``, the
supervisor's ``ENGINE_AUTO_RESTART`` and ``SUPERVISOR_*``, ``FAULT_POINTS``
(a spec that does not parse is a named startup error), ``FAULT_HTTP`` and
``TPU_WARMUP``; an unset ``DEFAULT_REPEAT_PENALTY`` resolves by provider.
The fleet settings (``ROUTER_*``, ``FLEET_*``, ``KV_MIGRATE_HTTP``,
``DISAGG_PREFILL_MIN_TOKENS`` and ``FLEET_FLIGHT_*``) have the JAX names,
defaults and messages (``fasttalk_tpu/utils/config.py`` :400-505,
:780-799, :982-1072, :1261-1271), but for ``FLEET_FLIGHT_DIR``, whose
default is the port's own directory.
The mesh and multi-rank SPMD settings (``TPU_TP_SIZE``, ``TPU_DP_SIZE``,
``TPU_SP_SIZE``, ``TPU_SPMD_ROLE``, ``TPU_SPMD_ADDR``,
``TPU_SPMD_FOLLOWERS``, ``SPMD_HB_INTERVAL_S``, ``SPMD_HB_TIMEOUT_S``)
have the JAX names, defaults, checks and messages
(``fasttalk_tpu/utils/config.py`` :222-251, :862-887), and so do the
refusals of int4, int8 KV, the paged layout and ``STRUCTURED_MODE=on`` on
a mesh (:954-965, :1088-1099, :1128-1137, :1185-1196) and of the router
under SPMD. The port runs one rank per device: a mesh or an SPMD role
without the process group's settings (``TPU_COORDINATOR_ADDR``,
``TPU_NUM_PROCESSES``) is refused with how to launch it, where the JAX
package can drive every local device from one process.

The device is not configuration: it is an argument of the entry points
(``resolve_device``), ``cuda`` unless the caller asks for the CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, fields
from typing import Any

import torch


# "tpu" names the in-tree engine, as in the JAX package.
VALID_PROVIDERS = ("tpu", "vllm", "ollama", "openai", "fake")


def _env_str(name: str, default: str) -> str:
    return os.getenv(name, default)


def _env_int(name: str, default: int) -> int:
    raw = os.getenv(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"env {name} must be an integer, got {raw!r}") from None


def _env_float(name: str, default: float) -> float:
    raw = os.getenv(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"env {name} must be a number, got {raw!r}") from None


def _env_bool(name: str, default: bool) -> bool:
    return os.getenv(name, "true" if default else "false").strip().lower() in (
        "1", "true", "yes", "on")


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when CUDA is asked for and absent — the port never
    carries on on the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; fasttalk_tpu_torch runs on the "
            "GPU unless the caller passes device='cpu' explicitly")
    return dev


@dataclass
class Config:
    """Serving settings, each overridable via its environment variable."""

    # Provider: "tpu" (the in-tree engine: the port's TorchEngine, under
    # the JAX package's name), "fake" (an in-memory engine for protocol
    # tests), or the "vllm"/"openai"/"ollama" HTTP passthrough.
    llm_provider: str = field(default_factory=lambda: _env_str("LLM_PROVIDER", "tpu"))
    model_name: str = field(default_factory=lambda: _env_str("LLM_MODEL", "llama3.2:1b"))
    model_path: str = field(default_factory=lambda: _env_str("MODEL_PATH", "/app/models"))
    decode_slots: int = field(default_factory=lambda: _env_int("TPU_DECODE_SLOTS", 16))
    # The mesh (parallel/mesh.py): tensor, data and sequence parallel.
    tp_size: int = field(default_factory=lambda: _env_int("TPU_TP_SIZE", 1))
    dp_size: int = field(default_factory=lambda: _env_int("TPU_DP_SIZE", 1))
    sp_size: int = field(default_factory=lambda: _env_int("TPU_SP_SIZE", 1))
    # Multi-rank SPMD serving (parallel/spmd_serving.py): "off" | "leader"
    # (serves the gateway and publishes every device call to the
    # followers over TPU_SPMD_ADDR) | "follower" (replays the leader's
    # calls against this rank's shards; no gateway). The process group
    # itself comes from TPU_COORDINATOR_ADDR / TPU_NUM_PROCESSES /
    # TPU_PROCESS_ID (parallel/distributed.py).
    spmd_role: str = field(
        default_factory=lambda: _env_str("TPU_SPMD_ROLE", "off"))
    spmd_addr: str = field(
        default_factory=lambda: _env_str("TPU_SPMD_ADDR",
                                         "127.0.0.1:8890"))
    spmd_followers: int = field(
        default_factory=lambda: _env_int("TPU_SPMD_FOLLOWERS", 1))
    # Cluster liveness: the leader heartbeats every interval (0 disables
    # the beacon), and a follower treats a leader silent past the timeout
    # as dead.
    spmd_hb_interval_s: float = field(
        default_factory=lambda: _env_float("SPMD_HB_INTERVAL_S", 2.0))
    spmd_hb_timeout_s: float = field(
        default_factory=lambda: _env_float("SPMD_HB_TIMEOUT_S", 8.0))
    max_model_len: int = field(default_factory=lambda: _env_int("TPU_MAX_MODEL_LEN", 8192))
    prefill_chunk: int = field(default_factory=lambda: _env_int("TPU_PREFILL_CHUNK", 512))
    decode_steps_per_call: int = field(
        default_factory=lambda: _env_int("TPU_DECODE_STEPS", 32))
    pipeline_depth: int = field(
        default_factory=lambda: _env_int("TPU_PIPELINE_DEPTH", 2))
    # Cross-session shared-prefix KV: a fresh session whose prompt starts
    # with rows resident in another slot (a common system prompt) gets them
    # by device copy instead of re-prefill, and a burst of fresh sessions
    # prefills one leader and copies its rows to the others.
    shared_prefix: bool = field(
        default_factory=lambda: _env_bool("TPU_SHARED_PREFIX", True))
    # Speculative decoding: "off" | "ngram" | "auto". "ngram" drafts by
    # prompt lookup over the slot's own token history on the device and
    # verifies draft + 1 positions in one decode block, accepting the
    # longest sampled-equal prefix (exactly distribution-preserving).
    # "auto" (default) decides per decode call from the engine's measured
    # acceptance EMA against TPU_SPEC_BREAKEVEN, probing periodically.
    spec_decode: str = field(
        default_factory=lambda: _env_str("TPU_SPEC_DECODE", "auto"))
    # Draft tokens proposed per verify block (block = draft + 1).
    spec_draft_len: int = field(
        default_factory=lambda: _env_int("TPU_SPEC_DRAFT", 7))
    # Auto-mode threshold: EMA tokens per verify block above which
    # speculative calls are taken (the cost of a verify block in plain
    # steps; the card's own figure is in PERF.md).
    spec_breakeven: float = field(
        default_factory=lambda: _env_float("TPU_SPEC_BREAKEVEN", 1.45))
    # Sampling candidate preselection: "fast" (block-max; greedy rows stay
    # exact) or "exact" (full-vocabulary top-k).
    sampling: str = field(
        default_factory=lambda: _env_str("TPU_SAMPLING", "fast"))
    # ---- Admission control (scheduling/scheduler.py) ----
    # Bound on requests waiting for a decode slot; the excess is shed at
    # once with a retry_after hint.
    sched_queue_bound: int = field(
        default_factory=lambda: _env_int("SCHED_QUEUE_BOUND", 256))
    # Default queue TTL: a request still waiting past it ends with a
    # terminal event before it touches the device (clients override with
    # the "deadline_s" session key).
    sched_default_deadline_s: float = field(
        default_factory=lambda: _env_float("SCHED_DEADLINE_S", 30.0))
    # Priority class when the client sets none: "interactive" admits
    # before "bulk" (the "priority" session key overrides).
    sched_default_priority: str = field(
        default_factory=lambda: _env_str("SCHED_DEFAULT_PRIORITY",
                                         "interactive"))
    # Starvation guard: a bulk request waiting longer than this admits
    # ahead of interactive work for one admission.
    sched_bulk_aging_s: float = field(
        default_factory=lambda: _env_float("SCHED_AGING_S", 5.0))
    # Graceful drain: how long server shutdown waits for queued and
    # running requests before cancelling the rest.
    sched_drain_timeout_s: float = field(
        default_factory=lambda: _env_float("SCHED_DRAIN_TIMEOUT_S", 30.0))
    # Legacy weight-tier knob: "none" | "int8" | "int4". WEIGHT_QUANT is the
    # name to use; TPU_QUANTIZE is its alias.
    quantize: str = field(default_factory=lambda: _env_str("TPU_QUANTIZE", "none"))
    # Serving weight tier: "" (unset: taken from TPU_QUANTIZE) | "off" |
    # "int8" | "int4" (group-wise symmetric 4-bit, nibble-packed, for the
    # seven layer matmuls; the embedding and lm_head stay per-row int8).
    weight_quant: str = field(default_factory=lambda: _env_str("WEIGHT_QUANT", ""))
    # Contraction rows sharing one int4 scale: even (a nibble pair never
    # straddles a group); that it divides the model's matmul dims is checked
    # at engine build (quantization/int4.py validate_group).
    weight_quant_group: int = field(
        default_factory=lambda: _env_int("WEIGHT_QUANT_GROUP", 128))
    # AWQ calibration source of ``python -m fasttalk_tpu_torch quantize``
    # when no --calib is given: "" (unset: "corpus"), "corpus" (the tinychat
    # training corpus) or a text file with one document per line. Serving
    # never calibrates: it restores the prepared cache the command writes,
    # and quantizes data-free when there is none.
    weight_quant_calib: str = field(
        default_factory=lambda: _env_str("WEIGHT_QUANT_CALIB", ""))
    # Validated as in the JAX package (it requires WEIGHT_QUANT=int4); a
    # no-op: on the port the hand-written int4_matmul kernel is
    # the int4 decode path on the card, as decode_attend is for attention.
    use_pallas_int4: bool = field(
        default_factory=lambda: _env_bool("TPU_USE_PALLAS_INT4", False))
    dtype: str = field(default_factory=lambda: _env_str("TPU_DTYPE", "bfloat16"))
    host: str = field(default_factory=lambda: _env_str("LLM_HOST", "0.0.0.0"))
    port: int = field(default_factory=lambda: _env_int("LLM_PORT", 8000))
    # The monitoring app (monitoring/monitor.py) that ``serve`` starts
    # beside the serving port (0 = an ephemeral port).
    monitoring_port: int = field(
        default_factory=lambda: _env_int("LLM_MONITORING_PORT", 9092))
    monitoring_host: str = field(
        default_factory=lambda: _env_str("LLM_MONITORING_HOST", "0.0.0.0"))
    max_connections: int = field(
        default_factory=lambda: _env_int("LLM_MAX_CONNECTIONS", 50))
    system_prompt: str = field(default_factory=lambda: _env_str(
        "SYSTEM_PROMPT",
        "You are a helpful voice assistant. Keep responses concise and conversational."))
    default_temperature: float = field(
        default_factory=lambda: _env_float("DEFAULT_TEMPERATURE", 0.7))
    default_max_tokens: int = field(
        default_factory=lambda: _env_int("DEFAULT_MAX_TOKENS", 2048))
    default_context_window: int = field(
        default_factory=lambda: _env_int("DEFAULT_CONTEXT_WINDOW", 8192))
    default_top_p: float = field(default_factory=lambda: _env_float("DEFAULT_TOP_P", 0.9))
    default_top_k: int = field(default_factory=lambda: _env_int("DEFAULT_TOP_K", 40))
    default_repeat_penalty: float = field(
        default_factory=lambda: _env_float("DEFAULT_REPEAT_PENALTY", -1.0))
    # Session defaults of the OpenAI-style additive penalties, in [-2, 2]
    # (fasttalk_tpu/utils/config.py :164-167, :848-851).
    default_presence_penalty: float = field(
        default_factory=lambda: _env_float("DEFAULT_PRESENCE_PENALTY", 0.0))
    default_frequency_penalty: float = field(
        default_factory=lambda: _env_float("DEFAULT_FREQUENCY_PENALTY", 0.0))
    session_timeout: int = field(default_factory=lambda: _env_int("SESSION_TIMEOUT", 3600))
    # ---- Remote providers (engine/remote.py) ----
    vllm_base_url: str = field(
        default_factory=lambda: _env_str("VLLM_BASE_URL", "http://vllm:8000/v1"))
    vllm_model: str = field(
        default_factory=lambda: _env_str(
            "VLLM_MODEL", "hugging-quants/Meta-Llama-3.1-8B-Instruct-AWQ-INT4"))
    vllm_api_key: str = field(default_factory=lambda: _env_str("VLLM_API_KEY", "not-needed"))
    vllm_timeout: float = field(default_factory=lambda: _env_float("VLLM_TIMEOUT", 600.0))
    ollama_base_url: str = field(
        default_factory=lambda: _env_str("OLLAMA_BASE_URL", "http://ollama:11434"))
    ollama_keep_alive: str = field(default_factory=lambda: _env_str("OLLAMA_KEEP_ALIVE", "5m"))
    ollama_timeout: float = field(default_factory=lambda: _env_float("OLLAMA_TIMEOUT", 600.0))
    # Cap on concurrent upstream requests of a remote provider; waiters
    # past the admission deadline shed with retry_after.
    remote_max_inflight: int = field(
        default_factory=lambda: _env_int("REMOTE_MAX_INFLIGHT", 32))
    # Bounded jittered retries of idempotent (pre-first-token) upstream
    # failures; 0 surfaces the first failure.
    remote_connect_retries: int = field(
        default_factory=lambda: _env_int("REMOTE_CONNECT_RETRIES", 2))
    # ---- Fleet router (fasttalk_tpu_torch/router/, docs/ROUTER.md) ----
    # Front a fleet of engine replicas behind this server instead of a
    # single engine: session-affinity routing, health probes, failover
    # with mid-stream resume, coordinated drain.
    router_enabled: bool = field(
        default_factory=lambda: _env_bool("ROUTER_ENABLED", False))
    # In-process engine replicas the router builds (each a full engine
    # instance: CPU fleets for test/bench, dp-style multi-engine on
    # real hardware). May be 0 when ROUTER_BACKENDS supplies the fleet.
    fleet_replicas: int = field(
        default_factory=lambda: _env_int("FLEET_REPLICAS", 2))
    # Comma-separated serving roots of remote FastTalk replicas
    # (e.g. "http://replica-1:8000,http://replica-2:8000"): generations
    # go through their /v1 surface via the existing remote.py client;
    # probes read their /health body.
    router_backends: str = field(
        default_factory=lambda: _env_str("ROUTER_BACKENDS", ""))
    # Health/load probe cadence (seconds); 0 disables the probe thread
    # (probes then only run on demand — tests).
    router_probe_interval_s: float = field(
        default_factory=lambda: _env_float("ROUTER_PROBE_INTERVAL_S",
                                           2.0))
    # How long an idle session stays pinned to its replica. Default
    # matches KV_PARK_TTL_S: once the parked KV has expired server-side
    # there is nothing left to be sticky to.
    router_affinity_ttl_s: float = field(
        default_factory=lambda: _env_float("ROUTER_AFFINITY_TTL_S",
                                           600.0))
    # Replica failures one request will route around before giving up.
    router_failover_retries: int = field(
        default_factory=lambda: _env_int("ROUTER_FAILOVER_RETRIES", 2))
    # Resume mid-stream failovers on a survivor (re-prefill from the
    # transcript; client sees a `resumed` event). Off = mid-stream
    # replica death surfaces as a terminal error instead.
    router_resume: bool = field(
        default_factory=lambda: _env_bool("ROUTER_RESUME", True))
    # Consecutive failed probes before a replica is marked dead (a
    # stream failing while the backend is unreachable marks it dead
    # immediately, independent of this).
    router_dead_probes: int = field(
        default_factory=lambda: _env_int("ROUTER_DEAD_PROBES", 2))
    # ---- Fleet session fabric (docs/ROUTER.md "Cross-replica KV
    # migration" / "Elastic replicas") ----
    # Move parked session KV between replicas on drain/failover so the
    # next turn RESTORES on the target instead of re-prefilling the
    # transcript. Off = the pre-fabric behaviour (drain releases the
    # entry, failover re-prefills).
    router_migrate: bool = field(
        default_factory=lambda: _env_bool("ROUTER_MIGRATE", True))
    # Hard bound on one migration transfer (export + wire + import).
    # A hung channel falls back to re-prefill — it must never wedge a
    # drain or a failover.
    router_migrate_timeout_s: float = field(
        default_factory=lambda: _env_float("ROUTER_MIGRATE_TIMEOUT_S",
                                           10.0))
    # Serve the /kv/parked/{session_id} migration endpoints on THIS
    # replica's serving port. Off by default: the port is
    # unauthenticated, and the channel exposes parked transcripts
    # (read), pool writes, and purges. Enable ONLY on replicas whose
    # serving port is reachable solely from the router network —
    # a remote router needs it to migrate KV in and out; in-process
    # fleets hand entries over directly and never need it.
    kv_migrate_http: bool = field(
        default_factory=lambda: _env_bool("KV_MIGRATE_HTTP", False))
    # Co-locate sessions sharing a system prompt on the replica that
    # already serves that prefix (hits the shared-prefix stamp /
    # paged block aliasing) while its load is within one queued
    # request of the best candidate.
    router_prefix_affinity: bool = field(
        default_factory=lambda: _env_bool("ROUTER_PREFIX_AFFINITY",
                                          True))
    # Elastic replica scaling (router/elastic.py). FLEET_SCALE_MAX=0
    # disables the scaler (fixed fleet); > 0 lets the launcher grow
    # the in-process fleet up to this size on queue depth / SLO burn
    # and shrink it back to FLEET_SCALE_MIN via client-invisible
    # drain-then-migrate after sustained idleness.
    fleet_scale_min: int = field(
        default_factory=lambda: _env_int("FLEET_SCALE_MIN", 1))
    fleet_scale_max: int = field(
        default_factory=lambda: _env_int("FLEET_SCALE_MAX", 0))
    # Aggregate queued requests across the fleet that trigger a
    # scale-up (an SLO page-burn triggers one regardless of depth).
    fleet_scale_up_queue: int = field(
        default_factory=lambda: _env_int("FLEET_SCALE_UP_QUEUE", 8))
    # Whole-fleet idle time (no queued, no running work) before one
    # replica is retired.
    fleet_scale_down_idle_s: float = field(
        default_factory=lambda: _env_float("FLEET_SCALE_DOWN_IDLE_S",
                                           120.0))
    # Scaler control-loop cadence.
    fleet_scale_check_s: float = field(
        default_factory=lambda: _env_float("FLEET_SCALE_CHECK_S", 5.0))
    # ---- Disaggregated prefill/decode serving (router/disagg.py,
    # docs/ROUTER.md "Disaggregated prefill/decode") ----
    # Per-replica roles for the in-process fleet, comma-separated,
    # one of prefill|decode|mixed per FLEET_REPLICAS slot (e.g.
    # "prefill,decode,decode"). Empty = every replica is "mixed"
    # (today's behaviour). A prefill-role replica runs long-context
    # chunked prefill with a deep queue and ZERO decode slots — it
    # parks the finished KV and the router hands it to the decode
    # tier over the /kv/parked migration wire.
    fleet_roles: str = field(
        default_factory=lambda: _env_str("FLEET_ROLES", ""))
    # Same, for ROUTER_BACKENDS remote replicas (one role per URL).
    router_backend_roles: str = field(
        default_factory=lambda: _env_str("ROUTER_BACKEND_ROLES", ""))
    # Prompt-length threshold (estimated tokens) above which a new
    # stream takes the prefill-tier handoff path; shorter prompts
    # place decode-local. Only meaningful when the fleet has a
    # prefill-role replica.
    disagg_prefill_min_tokens: int = field(
        default_factory=lambda: _env_int("DISAGG_PREFILL_MIN_TOKENS",
                                         512))
    # ---- The tool-calling agent (agents/) ----
    # Built by the launcher (serving/launcher.py build_agent) when both
    # are true, which is the default.
    enable_agent: bool = field(default_factory=lambda: _env_bool("ENABLE_PYDANTIC_AI", True))
    enable_web_search: bool = field(default_factory=lambda: _env_bool("ENABLE_WEB_SEARCH", True))
    enable_tools: bool = field(default_factory=lambda: _env_bool("ENABLE_TOOLS", True))
    web_search_rate_limit: float = field(
        default_factory=lambda: _env_float("DUCKDUCKGO_RATE_LIMIT", 1.0))
    # auto = live DuckDuckGo with offline fallback; duckduckgo; offline
    web_search_backend: str = field(
        default_factory=lambda: _env_str("WEB_SEARCH_BACKEND", "auto"))
    web_search_timeout: float = field(
        default_factory=lambda: _env_float("WEB_SEARCH_TIMEOUT", 10.0))
    # ---- Supervision (serving/launcher.py) ----
    # Supervised in-process engine restart after a crash.
    engine_auto_restart: bool = field(
        default_factory=lambda: _env_bool("ENGINE_AUTO_RESTART", True))
    # Restart-storm guard: at most max restarts per rolling window, with
    # exponential backoff from backoff_s (capped at 60 s) between
    # attempts; on exhaustion /health reports dead.
    supervisor_max_restarts: int = field(
        default_factory=lambda: _env_int("SUPERVISOR_MAX_RESTARTS", 5))
    supervisor_window_s: float = field(
        default_factory=lambda: _env_float("SUPERVISOR_WINDOW_S", 300.0))
    supervisor_backoff_s: float = field(
        default_factory=lambda: _env_float("SUPERVISOR_BACKOFF_S", 2.0))
    # ---- Fault injection (resilience/failpoints.py) ----
    # A validated spec of named failpoints to arm, e.g.
    # "engine.decode.dispatch=error;count=1,kv.park.copy=delay_ms:250".
    fault_points: str = field(
        default_factory=lambda: _env_str("FAULT_POINTS", ""))
    # Gates POST /debug/fault on the monitoring port (never in production).
    fault_http_enabled: bool = field(
        default_factory=lambda: _env_bool("FAULT_HTTP", False))
    # Warm-up before serving: "off" | "fast" | "full"; empty means "fast"
    # for the in-tree engine and "off" for the remote and fake providers.
    # It builds the kernels and runs the serving shapes through them, so
    # the first request pays neither.
    warmup: str = field(default_factory=lambda: _env_str("TPU_WARMUP", ""))
    # Share of the card's memory the weights and the KV cache may take.
    hbm_util: float = field(
        default_factory=lambda: _env_float("TPU_HBM_UTILIZATION", 0.9))
    # Int8 KV-cache tier: "none" | "int8" (int8 rows + f32 row scales,
    # half the cache's bytes and half what each decode step reads).
    kv_quant: str = field(default_factory=lambda: _env_str("KV_QUANT", "none"))
    # Scale granularity: "token" (one scale per K/V row) or "head" (one per
    # KV head of the row).
    kv_quant_granule: str = field(
        default_factory=lambda: _env_str("KV_QUANT_GRANULE", "token"))
    # "dense" preallocates every slot at TPU_MAX_MODEL_LEN; "paged" holds one
    # block pool with per-slot block tables, priced at the blocks in use.
    kv_layout: str = field(
        default_factory=lambda: _env_str("KV_LAYOUT", "dense"))
    # Tokens per block: a power of two in [8, 512].
    kv_block_size: int = field(
        default_factory=lambda: _env_int("KV_BLOCK_SIZE", 16))
    # Pool size in blocks; 0 = the dense-equivalent pool, shrunk by the
    # factory to what the memory budget holds.
    kv_pool_blocks: int = field(
        default_factory=lambda: _env_int("KV_POOL_BLOCKS", 0))
    # Decode growth an admission must see free: "fixed" (the next
    # KV_RESERVE_TOKENS), "max_tokens" (the whole budget) or "none".
    kv_reserve_policy: str = field(
        default_factory=lambda: _env_str("KV_RESERVE_POLICY", "fixed"))
    kv_reserve_tokens: int = field(
        default_factory=lambda: _env_int("KV_RESERVE_TOKENS", 128))
    # ---- Session KV host-offload tier (kvcache/) ----
    # Host-RAM budget for parked session KV (MB); 0 disables the tier (an
    # evicted session re-prefills its history). Above the machine's RAM a
    # warning is logged.
    kv_host_budget_mb: float = field(
        default_factory=lambda: _env_float("KV_HOST_BUDGET_MB", 0.0))
    # Parked entries idle past this are dropped.
    kv_park_ttl_s: float = field(
        default_factory=lambda: _env_float("KV_PARK_TTL_S", 600.0))
    # A pinned session idle this long is parked as well (its slot stays
    # pinned); 0 parks on eviction only.
    kv_park_idle_s: float = field(
        default_factory=lambda: _env_float("KV_PARK_IDLE_S", 30.0))
    # Matched prefix below which a restore is never worth its copy.
    kv_restore_min_tokens: int = field(
        default_factory=lambda: _env_int("KV_RESTORE_MIN_TOKENS", 32))
    # ---- Radix prefix cache (kvcache/radix.py; KV_LAYOUT=paged) ----
    # Finished and departing sessions donate their clean prefix blocks to
    # a radix tree; an admission aliases the longest cached chain and
    # prefills only the delta.
    kv_radix_enabled: bool = field(
        default_factory=lambda: _env_bool("KV_RADIX_ENABLED", False))
    # Free-block headroom the tree keeps after an insert (0 = rely on
    # eviction under pressure alone); below KV_POOL_BLOCKS when that is set.
    kv_radix_min_blocks: int = field(
        default_factory=lambda: _env_int("KV_RADIX_MIN_BLOCKS", 0))
    # "lru" (least recently matched leaves first) or "fifo".
    kv_radix_evict_policy: str = field(
        default_factory=lambda: _env_str("KV_RADIX_EVICT_POLICY", "lru"))
    # ---- Structured decoding (structured/) ----
    # "auto" (default): constrained requests are served whenever the engine
    # supports them, else rejected with a named reason; "on": an
    # unsupported engine is a startup error; "off": every structured
    # request is rejected. Speculative decoding pauses per decode call
    # while a constrained slot runs and resumes after.
    structured_mode: str = field(
        default_factory=lambda: _env_str("STRUCTURED_MODE", "auto"))
    # Per-FSM compile bound: a schema whose token FSM exceeds this many
    # states is rejected with a 400 naming the count.
    structured_max_states: int = field(
        default_factory=lambda: _env_int("STRUCTURED_MAX_STATES", 8192))
    # Device union-arena budget: total FSM states resident across all
    # concurrently served schemas.
    structured_state_budget: int = field(
        default_factory=lambda: _env_int("STRUCTURED_STATE_BUDGET",
                                         16384))
    # Jump-forward engages when the FSM's forced single-transition chain is
    # at least this many tokens (0 disables jump-forward).
    structured_jf_min: int = field(
        default_factory=lambda: _env_int("STRUCTURED_JF_MIN", 4))
    # Compiled-FSM LRU entries per engine.
    structured_cache: int = field(
        default_factory=lambda: _env_int("STRUCTURED_CACHE", 64))
    # response_format={"type":"json_object"} nesting depth ("any JSON" is
    # not regular, so the generic grammar unrolls this many levels).
    structured_json_depth: int = field(
        default_factory=lambda: _env_int("STRUCTURED_JSON_DEPTH", 3))

    # ---- SLOs + stall watchdog (observability/slo.py, watchdog.py). The
    # observability singletons read the same environment names at
    # construction; these fields are their one validated surface. ----
    # Latency promises for the interactive class (ms); bulk relaxes the
    # latency targets by SLO_BULK_FACTOR (default 4x) unless overridden
    # per class (SLO_BULK_TTFT_P95_MS, ...).
    slo_ttft_p95_ms: float = field(
        default_factory=lambda: _env_float("SLO_TTFT_P95_MS", 1500.0))
    slo_inter_token_p99_ms: float = field(
        default_factory=lambda: _env_float("SLO_INTER_TOKEN_P99_MS",
                                           250.0))
    slo_queue_wait_p95_ms: float = field(
        default_factory=lambda: _env_float("SLO_QUEUE_WAIT_P95_MS",
                                           1000.0))
    slo_error_rate: float = field(
        default_factory=lambda: _env_float("SLO_ERROR_RATE", 0.01))
    # Burn-rate alert thresholds: page on fast+mid windows burning at
    # >= page_burn, warn on mid+long windows at >= warn_burn.
    slo_page_burn: float = field(
        default_factory=lambda: _env_float("SLO_PAGE_BURN", 10.0))
    slo_warn_burn: float = field(
        default_factory=lambda: _env_float("SLO_WARN_BURN", 2.0))
    # While the interactive class page-burns, shed incoming bulk at
    # admission (scheduling/scheduler.py slo_gate).
    slo_shed_bulk_on_page: bool = field(
        default_factory=lambda: _env_bool("SLO_SHED_BULK_ON_PAGE", True))
    # Watchdog: a request with no token for token_stall_s is flagged;
    # past WATCHDOG_CANCEL_STALL_S (default 2x) it is terminated with a
    # terminal error frame. An engine loop heartbeat older than
    # step_stall_s with pending work is a hung step.
    watchdog_token_stall_s: float = field(
        default_factory=lambda: _env_float("WATCHDOG_TOKEN_STALL_S",
                                           30.0))
    watchdog_step_stall_s: float = field(
        default_factory=lambda: _env_float("WATCHDOG_STEP_STALL_S",
                                           15.0))
    # Unset (-1) resolves to 2x the token stall in __post_init__,
    # matching the watchdog's own env fallback.
    watchdog_cancel_stall_s: float = field(
        default_factory=lambda: _env_float("WATCHDOG_CANCEL_STALL_S",
                                           -1.0))
    watchdog_interval_s: float = field(
        default_factory=lambda: _env_float("WATCHDOG_INTERVAL_S", 1.0))
    watchdog_loop_lag_ms: float = field(
        default_factory=lambda: _env_float("WATCHDOG_LOOP_LAG_MS",
                                           500.0))
    # Percentile-window horizon for /stats histograms (seconds): p95s
    # reflect the last metrics_window_s (utils/metrics.py). <= 0 restores
    # the pure sample-count window.
    metrics_window_s: float = field(
        default_factory=lambda: _env_float("METRICS_WINDOW_S", 300.0))
    # ---- Performance attribution ledger (observability/perf.py) ----
    # Rolling window the attribution report covers (seconds).
    perf_window_s: float = field(
        default_factory=lambda: _env_float("PERF_WINDOW_S", 60.0))
    # Gap between device spans longer than this counts as idle (no
    # work); shorter gaps are host overhead between calls.
    perf_idle_gap_ms: float = field(
        default_factory=lambda: _env_float("PERF_IDLE_GAP_MS", 250.0))
    # Roofline peaks for MFU (bf16 TFLOP/s) and HBM bandwidth (GB/s);
    # 0 = read them from the card's name; other devices report null.
    perf_peak_tflops: float = field(
        default_factory=lambda: _env_float("PERF_PEAK_TFLOPS", 0.0))
    perf_peak_hbm_gbps: float = field(
        default_factory=lambda: _env_float("PERF_PEAK_HBM_GBPS", 0.0))
    # ---- Continuous host profiler (observability/profiler.py) ----
    # Master switch: off spawns no sampler thread.
    prof_enabled: bool = field(
        default_factory=lambda: _env_bool("PROF_ENABLED", True))
    # Sampling rate of the host stack sampler (Hz).
    prof_hz: float = field(
        default_factory=lambda: _env_float("PROF_HZ", 67.0))
    # Bound on distinct collapsed stacks kept.
    prof_max_stacks: int = field(
        default_factory=lambda: _env_int("PROF_MAX_STACKS", 2000))
    # ---- Incident flight recorder (observability/flight.py) ----
    flight_enabled: bool = field(
        default_factory=lambda: _env_bool("FLIGHT_ENABLED", True))
    # The port's own directory (the JAX package's is
    # /tmp/fasttalk-tpu-flight): the two packages never share bundles.
    flight_dir: str = field(
        default_factory=lambda: _env_str("FLIGHT_DIR",
                                         "/tmp/fasttalk-tpu-torch-flight"))
    # Retention: only the newest N bundle directories are kept.
    flight_max_bundles: int = field(
        default_factory=lambda: _env_int("FLIGHT_MAX_BUNDLES", 8))
    # Rate limit: at most one automatic bundle per this many seconds.
    flight_min_interval_s: float = field(
        default_factory=lambda: _env_float("FLIGHT_MIN_INTERVAL_S",
                                           120.0))
    # > 0: each bundle also captures a torch.profiler Chrome trace of
    # the next N seconds (cuda_trace/).
    flight_autoprof_s: float = field(
        default_factory=lambda: _env_float("FLIGHT_AUTOPROF_S", 0.0))
    # This many serving-time recompile events within
    # flight_recompile_window_s trigger a bundle.
    flight_recompile_burst: int = field(
        default_factory=lambda: _env_int("FLIGHT_RECOMPILE_BURST", 5))
    flight_recompile_window_s: float = field(
        default_factory=lambda: _env_float("FLIGHT_RECOMPILE_WINDOW_S",
                                           60.0))
    # How many newest-first events each bundle's events.json carries.
    flight_events_tail: int = field(
        default_factory=lambda: _env_int("FLIGHT_EVENTS_TAIL", 256))
    # ---- The token journey (observability/journey.py) ----
    # Server-side kill switch; the per-session journey:true opt-in is
    # ignored when false.
    journey_enabled: bool = field(
        default_factory=lambda: _env_bool("JOURNEY_ENABLED", True))
    # Reconciliation tolerance for derived checks of the hop sums.
    journey_tol: float = field(
        default_factory=lambda: _env_float("JOURNEY_TOL", 0.10))
    # ---- Fleet flight recorder (observability/fleetflight.py):
    # router-side incident triggers fan bundle collection out to every
    # live replica (router-fronted processes only) ----
    fleet_flight_enabled: bool = field(
        default_factory=lambda: _env_bool("FLEET_FLIGHT_ENABLED", True))
    fleet_flight_dir: str = field(
        default_factory=lambda: _env_str(
            "FLEET_FLIGHT_DIR", "/tmp/fasttalk-tpu-torch-fleet-flight"))
    fleet_flight_max_bundles: int = field(
        default_factory=lambda: _env_int("FLEET_FLIGHT_MAX_BUNDLES", 4))
    fleet_flight_min_interval_s: float = field(
        default_factory=lambda: _env_float("FLEET_FLIGHT_MIN_INTERVAL_S",
                                           120.0))
    # This many failovers within fleet_flight_window_s counts as a
    # failover burst and triggers a fleet bundle.
    fleet_flight_failover_burst: int = field(
        default_factory=lambda: _env_int("FLEET_FLIGHT_FAILOVER_BURST",
                                         3))
    fleet_flight_window_s: float = field(
        default_factory=lambda: _env_float("FLEET_FLIGHT_WINDOW_S",
                                           60.0))

    def __post_init__(self) -> None:
        if not self.warmup:
            self.warmup = "fast" if self.llm_provider == "tpu" else "off"
        if self.default_repeat_penalty < 0:  # unset: provider-resolved
            self.default_repeat_penalty = \
                1.0 if self.llm_provider == "vllm" else 1.1
        if self.watchdog_cancel_stall_s == -1.0:  # unset: 2x token stall
            self.watchdog_cancel_stall_s = 2.0 * self.watchdog_token_stall_s
        # WEIGHT_QUANT unset: take the legacy TPU_QUANTIZE tier; set: it is
        # authoritative and the legacy field is brought into agreement. Two
        # different tiers are a named error below, never a silent precedence
        # (fasttalk_tpu/utils/config.py :818-829, :931-937).
        if not self.weight_quant:
            self.weight_quant = {"none": "off"}.get(self.quantize, self.quantize)
        elif self.quantize == "none" \
                and self.weight_quant in ("off", "int8", "int4"):
            self.quantize = {"off": "none"}.get(self.weight_quant,
                                                self.weight_quant)
        errs: list[str] = []
        if self.tp_size <= 0 or self.dp_size <= 0 or self.sp_size <= 0:
            errs.append("tp_size, dp_size and sp_size must be >= 1")
        if self.spmd_role not in ("off", "leader", "follower"):
            errs.append("spmd_role must be off|leader|follower")
        if self.spmd_role != "off":
            if ":" not in self.spmd_addr:
                errs.append("spmd_addr must be host:port")
            if self.spmd_followers <= 0:
                errs.append("spmd_followers must be >= 1")
        if self.spmd_hb_interval_s < 0:
            errs.append("spmd_hb_interval_s must be >= 0 (0 disables "
                        "the leader heartbeat beacon)")
        if self.spmd_hb_timeout_s < 0:
            errs.append("spmd_hb_timeout_s must be >= 0 (0 disables "
                        "the follower recv deadline)")
        if self.spmd_hb_interval_s > 0 and self.spmd_hb_timeout_s > 0 \
                and self.spmd_hb_timeout_s <= self.spmd_hb_interval_s:
            errs.append(
                "spmd_hb_timeout_s must exceed spmd_hb_interval_s "
                "(a deadline shorter than the beacon period declares "
                "a healthy leader dead)")
        if self.spmd_hb_interval_s == 0 and self.spmd_hb_timeout_s > 0:
            errs.append(
                "SPMD_HB_INTERVAL_S=0 (heartbeats off) requires "
                "SPMD_HB_TIMEOUT_S=0: a follower recv deadline with "
                "no heartbeats on the wire declares a healthy idle "
                "leader dead")
        if (self.mesh_size > 1 or self.spmd_role != "off") \
                and (not self.process_group_configured()
                     or self.spmd_role == "off"):
            errs.append(
                "TPU_TP_SIZE/TPU_DP_SIZE/TPU_SP_SIZE > 1 and TPU_SPMD_ROLE "
                "need one process per device under torch.distributed "
                "(fasttalk_tpu_torch has no single-process multi-device "
                "mode): start tp*dp*sp ranks, each with "
                "TPU_COORDINATOR_ADDR=<rank 0 host:port>, "
                "TPU_NUM_PROCESSES=<ranks> and TPU_PROCESS_ID=<its rank>, "
                "rank 0 with TPU_SPMD_ROLE=leader and the others with "
                "TPU_SPMD_ROLE=follower (TPU_SPMD_FOLLOWERS=<ranks - 1>)")
        if self.llm_provider not in VALID_PROVIDERS:
            errs.append(f"llm_provider must be one of {VALID_PROVIDERS}")
        if self.fleet_replicas < 0:
            errs.append("fleet_replicas must be >= 0")
        if self.router_probe_interval_s < 0:
            errs.append("router_probe_interval_s must be >= 0 "
                        "(0 disables the probe thread)")
        if self.router_affinity_ttl_s <= 0:
            errs.append("router_affinity_ttl_s must be > 0")
        if self.router_failover_retries < 0:
            errs.append("router_failover_retries must be >= 0")
        if self.router_dead_probes < 1:
            errs.append("router_dead_probes must be >= 1")
        if self.router_migrate_timeout_s <= 0:
            errs.append("router_migrate_timeout_s must be > 0 (a hung "
                        "migration must never wedge a drain; disable "
                        "migration with ROUTER_MIGRATE=false instead)")
        if self.fleet_scale_min < 1:
            errs.append("fleet_scale_min must be >= 1 (the fleet "
                        "never scales to zero replicas)")
        if self.fleet_scale_max < 0:
            errs.append("fleet_scale_max must be >= 0 (0 disables "
                        "elastic scaling)")
        if self.fleet_scale_max > 0 \
                and self.fleet_scale_max < self.fleet_scale_min:
            errs.append(f"fleet_scale_max ({self.fleet_scale_max}) "
                        f"must be >= fleet_scale_min "
                        f"({self.fleet_scale_min})")
        if self.fleet_scale_max > 0 and not self.router_enabled:
            errs.append("FLEET_SCALE_MAX > 0 requires "
                        "ROUTER_ENABLED=true (the elastic scaler "
                        "drives a FleetRouter)")
        if self.fleet_scale_up_queue < 1:
            errs.append("fleet_scale_up_queue must be >= 1")
        if self.fleet_scale_down_idle_s <= 0:
            errs.append("fleet_scale_down_idle_s must be > 0")
        if self.fleet_scale_check_s <= 0:
            errs.append("fleet_scale_check_s must be > 0")
        _role_values = ("prefill", "decode", "mixed")
        _all_roles: list[str] = []
        for spec, env, count, what in (
                (self.fleet_roles, "FLEET_ROLES",
                 self.fleet_replicas, "FLEET_REPLICAS"),
                (self.router_backend_roles, "ROUTER_BACKEND_ROLES",
                 len([u for u in self.router_backends.split(",")
                      if u.strip()]), "ROUTER_BACKENDS"),
        ):
            if not spec.strip():
                continue
            roles = [r.strip().lower() for r in spec.split(",")]
            bad = [r for r in roles if r not in _role_values]
            if bad:
                errs.append(f"{env} contains invalid role(s) "
                            f"{bad!r} (each must be one of "
                            f"prefill|decode|mixed)")
                continue
            if len(roles) != count:
                errs.append(f"{env} lists {len(roles)} role(s) but "
                            f"{what} defines {count} replica(s) — "
                            "one role per replica, in order")
                continue
            _all_roles.extend(roles)
        if _all_roles:
            if not self.router_enabled:
                errs.append("FLEET_ROLES/ROUTER_BACKEND_ROLES require "
                            "ROUTER_ENABLED=true (replica roles are a "
                            "router placement concept)")
            if "prefill" in _all_roles and not self.router_migrate:
                errs.append("a 'prefill' replica role requires "
                            "ROUTER_MIGRATE=true (prefill replicas "
                            "hand finished KV to the decode tier over "
                            "the /kv/parked migration wire; without "
                            "migration their output is unreachable)")
            if "prefill" in _all_roles \
                    and not any(r in ("decode", "mixed")
                                for r in _all_roles):
                errs.append("a fleet with 'prefill' roles needs at "
                            "least one 'decode' or 'mixed' replica to "
                            "run the decode side of the handoff")
        if self.disagg_prefill_min_tokens < 1:
            errs.append("disagg_prefill_min_tokens must be >= 1")
        if self.router_enabled:
            n_remote = len([u for u in self.router_backends.split(",")
                            if u.strip()])
            if self.fleet_replicas + n_remote < 1:
                errs.append("router_enabled needs at least one replica "
                            "(FLEET_REPLICAS >= 1 or ROUTER_BACKENDS)")
            if self.spmd_role != "off":
                errs.append("router_enabled is incompatible with "
                            "multi-host SPMD serving (spmd_role must "
                            "be 'off'; an SPMD cluster is ONE logical "
                            "replica — front it via ROUTER_BACKENDS "
                            "from a separate router process)")
        if self.supervisor_max_restarts < 1:
            errs.append("supervisor_max_restarts must be >= 1")
        if self.supervisor_window_s <= 0:
            errs.append("supervisor_window_s must be > 0")
        if self.supervisor_backoff_s <= 0:
            errs.append("supervisor_backoff_s must be > 0")
        if self.fault_points.strip():
            # A drill with a mistyped point or action is a named startup
            # error, never a silently disabled drill.
            from fasttalk_tpu_torch.resilience.failpoints import parse_spec

            try:
                parse_spec(self.fault_points)
            except ValueError as e:
                errs.append(str(e))
        if self.warmup not in ("off", "fast", "full"):
            errs.append("warmup must be 'off', 'fast' or 'full'")
        if self.quantize not in ("none", "int8", "int4"):
            errs.append("quantize must be 'none', 'int8' or 'int4'")
        if self.weight_quant not in ("off", "int8", "int4"):
            errs.append(f"WEIGHT_QUANT must be off|int8|int4, "
                        f"got {self.weight_quant!r}")
        elif self.quantize in ("none", "int8", "int4") \
                and {"off": "none"}.get(self.weight_quant,
                                        self.weight_quant) != self.quantize:
            errs.append(
                f"WEIGHT_QUANT={self.weight_quant} conflicts with "
                f"legacy TPU_QUANTIZE={self.quantize}; set only "
                f"WEIGHT_QUANT (TPU_QUANTIZE is its alias)")
        if self.weight_quant_group < 2 or self.weight_quant_group % 2:
            errs.append(
                f"WEIGHT_QUANT_GROUP must be an even integer >= 2 (int4 "
                f"packs adjacent rows into one byte, so a scale group "
                f"must never split a nibble pair), got "
                f"{self.weight_quant_group}")
        if self.weight_quant_calib and self.weight_quant_calib != "corpus" \
                and not os.path.isfile(self.weight_quant_calib):
            errs.append(
                f"WEIGHT_QUANT_CALIB must be '' (unset), 'corpus', "
                f"or a readable prompt file (one per line); no file at "
                f"{self.weight_quant_calib!r}")
        if self.use_pallas_int4 and self.weight_quant != "int4":
            errs.append(
                "TPU_USE_PALLAS_INT4=true requires WEIGHT_QUANT=int4 "
                "(the kernel reads nibble-packed {'q4','s'} leaves)")
        if self.weight_quant == "int4":
            if self.mesh_size > 1:
                errs.append(
                    "WEIGHT_QUANT=int4 is single-device only in v1 "
                    "(partition rules for the q4/scale leaves exist — "
                    "parallel/sharding.py — but the sharded load/init "
                    "path is unvalidated); set TPU_TP_SIZE=TPU_DP_SIZE="
                    "TPU_SP_SIZE=1")
            if self.spmd_role != "off":
                errs.append("WEIGHT_QUANT=int4 is incompatible with "
                            "multi-host SPMD serving; set "
                            "TPU_SPMD_ROLE=off")
        if self.dtype not in ("bfloat16", "float32", "float16"):
            errs.append(f"TPU_DTYPE must be bfloat16|float32|float16, "
                        f"got {self.dtype!r}")
        if self.decode_slots <= 0:
            errs.append("TPU_DECODE_SLOTS must be > 0")
        if self.max_model_len <= 0:
            errs.append("TPU_MAX_MODEL_LEN must be > 0")
        if self.prefill_chunk <= 0 or self.prefill_chunk & (self.prefill_chunk - 1):
            errs.append("TPU_PREFILL_CHUNK must be a positive power of two")
        if self.decode_steps_per_call <= 0:
            errs.append("TPU_DECODE_STEPS must be >= 1")
        if self.pipeline_depth <= 0:
            errs.append("TPU_PIPELINE_DEPTH must be >= 1")
        if self.spec_decode not in ("off", "ngram", "auto"):
            errs.append(
                f"spec_decode must be off|ngram|auto, "
                f"got {self.spec_decode!r}")
        if self.spec_decode != "off" and not 1 <= self.spec_draft_len <= 31:
            errs.append("spec_draft_len must be in 1..31")
        if self.spec_breakeven <= 0:
            errs.append("spec_breakeven must be > 0")
        if self.sampling not in ("fast", "exact"):
            errs.append(f"TPU_SAMPLING must be fast|exact, "
                        f"got {self.sampling!r}")
        if self.sched_queue_bound <= 0:
            errs.append("sched_queue_bound must be > 0")
        if self.sched_default_deadline_s <= 0:
            errs.append("sched_default_deadline_s must be > 0")
        if self.sched_default_priority not in ("interactive", "bulk"):
            errs.append("sched_default_priority must be "
                        "'interactive' or 'bulk'")
        if self.sched_bulk_aging_s <= 0:
            errs.append("sched_bulk_aging_s must be > 0")
        if self.sched_drain_timeout_s < 0:
            errs.append("sched_drain_timeout_s must be >= 0")
        if not 0.0 <= self.default_temperature <= 2.0:
            errs.append("DEFAULT_TEMPERATURE must be in [0, 2]")
        if not 0.0 < self.default_top_p <= 1.0:
            errs.append("DEFAULT_TOP_P must be in (0, 1]")
        if self.default_top_k < 0:
            errs.append("DEFAULT_TOP_K must be >= 0")
        if self.default_max_tokens <= 0:
            errs.append("DEFAULT_MAX_TOKENS must be > 0")
        if not 0.0 < self.default_repeat_penalty <= 2.0:
            errs.append("DEFAULT_REPEAT_PENALTY must be in (0, 2]")
        if not -2.0 <= self.default_presence_penalty <= 2.0:
            errs.append("default_presence_penalty must be in [-2, 2]")
        if not -2.0 <= self.default_frequency_penalty <= 2.0:
            errs.append("default_frequency_penalty must be in [-2, 2]")
        if not 0.0 < self.hbm_util <= 1.0:
            errs.append("TPU_HBM_UTILIZATION must be in (0, 1]")
        if self.kv_quant not in ("none", "int8"):
            errs.append("kv_quant must be 'none' or 'int8'")
        if self.kv_quant_granule not in ("token", "head"):
            errs.append("kv_quant_granule must be 'token' or 'head'")
        if self.kv_quant == "int8":
            if self.mesh_size > 1:
                errs.append(
                    "KV_QUANT=int8 is single-device only (the per-row "
                    "scale arrays do not shard with the kv axis yet); "
                    "set TPU_TP_SIZE=TPU_DP_SIZE=TPU_SP_SIZE=1")
            if self.spmd_role != "off":
                errs.append("KV_QUANT=int8 is incompatible with "
                            "multi-host SPMD serving (sharded cache); "
                            "set TPU_SPMD_ROLE=off")
        if self.kv_quant == "int8" and self.spec_decode != "off":
            errs.append(
                "KV_QUANT=int8 is incompatible with speculative "
                "decoding (the spec carry does not thread the "
                "scale arrays through the verify block) — set "
                "TPU_SPEC_DECODE=off")
        if self.kv_layout not in ("dense", "paged"):
            errs.append(f"kv_layout must be 'dense' or 'paged', "
                        f"got {self.kv_layout!r}")
        if (self.kv_block_size < 8 or self.kv_block_size > 512
                or self.kv_block_size & (self.kv_block_size - 1)):
            errs.append(f"kv_block_size must be a power of two in "
                        f"[8, 512], got {self.kv_block_size}")
        if self.kv_pool_blocks < 0:
            errs.append("kv_pool_blocks must be >= 0 (0 sizes the pool "
                        "to the dense-equivalent footprint)")
        if self.kv_reserve_policy not in ("none", "fixed", "max_tokens"):
            errs.append(f"kv_reserve_policy must be none|fixed|"
                        f"max_tokens, got {self.kv_reserve_policy!r}")
        if self.kv_reserve_tokens < 0:
            errs.append("kv_reserve_tokens must be >= 0")
        if self.kv_layout == "paged":
            if self.mesh_size > 1:
                errs.append(
                    "KV_LAYOUT=paged is single-device only (the block "
                    "pool and per-slot tables are host-orchestrated "
                    "per chip); set TPU_TP_SIZE=TPU_DP_SIZE="
                    "TPU_SP_SIZE=1")
            if self.spmd_role != "off":
                errs.append("KV_LAYOUT=paged is incompatible with "
                            "multi-host SPMD serving; set "
                            "TPU_SPMD_ROLE=off")
        if self.kv_layout == "paged" \
                and self.kv_block_size > self.max_model_len:
            errs.append(f"kv_block_size ({self.kv_block_size}) must not "
                        f"exceed max_model_len ({self.max_model_len})")
        if self.kv_host_budget_mb < 0:
            errs.append("kv_host_budget_mb must be >= 0 (0 disables "
                        "the host-offload tier)")
        if self.kv_park_ttl_s <= 0:
            errs.append("kv_park_ttl_s must be > 0")
        if self.kv_park_idle_s < 0:
            errs.append("kv_park_idle_s must be >= 0 (0 disables "
                        "idle parking)")
        if self.kv_restore_min_tokens < 1:
            errs.append("kv_restore_min_tokens must be >= 1")
        if self.kv_radix_enabled and self.kv_layout != "paged":
            errs.append(
                "KV_RADIX_ENABLED=true requires KV_LAYOUT=paged (the "
                "radix prefix cache holds device pool blocks; the "
                "dense layout has no block pool to cache into)")
        if self.kv_radix_min_blocks < 0:
            errs.append("kv_radix_min_blocks must be >= 0")
        elif self.kv_radix_enabled and self.kv_pool_blocks \
                and self.kv_radix_min_blocks >= self.kv_pool_blocks:
            errs.append(
                f"kv_radix_min_blocks ({self.kv_radix_min_blocks}) "
                f"must be < kv_pool_blocks ({self.kv_pool_blocks}) — "
                "a headroom floor covering the whole pool leaves the "
                "cache nothing to hold")
        if self.kv_radix_evict_policy not in ("lru", "fifo"):
            errs.append(f"kv_radix_evict_policy must be lru|fifo, "
                        f"got {self.kv_radix_evict_policy!r}")
        if self.structured_mode not in ("auto", "on", "off"):
            errs.append(f"structured_mode must be auto|on|off, "
                        f"got {self.structured_mode!r}")
        if self.structured_mode == "on":
            if self.mesh_size > 1:
                errs.append(
                    "STRUCTURED_MODE=on is single-device only in v1 "
                    "(per-slot FSM state is not threaded through the "
                    "sharded decode path); set "
                    "TPU_TP_SIZE=TPU_DP_SIZE=TPU_SP_SIZE=1 or "
                    "STRUCTURED_MODE=auto")
            if self.spmd_role != "off":
                errs.append("STRUCTURED_MODE=on is incompatible with "
                            "multi-host SPMD serving; set "
                            "TPU_SPMD_ROLE=off")
        if self.structured_max_states < 16:
            errs.append(f"structured_max_states must be >= 16, "
                        f"got {self.structured_max_states}")
        if self.structured_state_budget < self.structured_max_states:
            errs.append(
                f"structured_state_budget "
                f"({self.structured_state_budget}) must be >= "
                f"structured_max_states ({self.structured_max_states}) "
                "or the largest admissible FSM could never be pinned")
        if self.structured_jf_min < 0:
            errs.append(f"structured_jf_min must be >= 0 (0 disables "
                        f"jump-forward), got {self.structured_jf_min}")
        if self.structured_cache < 1:
            errs.append(f"structured_cache must be >= 1, "
                        f"got {self.structured_cache}")
        if not 1 <= self.structured_json_depth <= 8:
            errs.append(f"structured_json_depth must be in 1..8, "
                        f"got {self.structured_json_depth}")
        if self.port == self.monitoring_port and self.port != 0:
            errs.append("port and monitoring_port must differ")
        for name in ("slo_ttft_p95_ms", "slo_inter_token_p99_ms",
                     "slo_queue_wait_p95_ms", "slo_page_burn",
                     "slo_warn_burn", "watchdog_token_stall_s",
                     "watchdog_step_stall_s", "watchdog_interval_s",
                     "watchdog_cancel_stall_s", "watchdog_loop_lag_ms"):
            if getattr(self, name) <= 0:
                errs.append(f"{name} must be > 0")
        if not (0.0 < self.slo_error_rate <= 1.0):
            errs.append("slo_error_rate must be in (0, 1]")
        if self.perf_window_s <= 0:
            errs.append("perf_window_s must be > 0")
        if self.perf_idle_gap_ms <= 0:
            errs.append("perf_idle_gap_ms must be > 0")
        if self.perf_peak_tflops < 0:
            errs.append("perf_peak_tflops must be >= 0 (0 = detect "
                        "from the device kind)")
        if self.perf_peak_hbm_gbps < 0:
            errs.append("perf_peak_hbm_gbps must be >= 0 (0 = detect "
                        "from the device kind)")
        if self.prof_hz <= 0 or self.prof_hz > 1000:
            errs.append("prof_hz must be in (0, 1000] — the host "
                        "stack sampler rate in Hz")
        if self.prof_max_stacks < 16:
            errs.append("prof_max_stacks must be >= 16 (the bound on "
                        "distinct stacks kept per thread role)")
        if not self.flight_dir.strip():
            errs.append("flight_dir must be a non-empty path")
        if self.flight_max_bundles < 1:
            errs.append("flight_max_bundles must be >= 1")
        if self.flight_min_interval_s < 0:
            errs.append("flight_min_interval_s must be >= 0")
        if self.flight_autoprof_s < 0:
            errs.append("flight_autoprof_s must be >= 0 (0 disables "
                        "the automatic profiler capture)")
        if self.flight_recompile_burst < 2:
            errs.append("flight_recompile_burst must be >= 2 (one "
                        "recompile is an event, not an incident)")
        if self.flight_recompile_window_s <= 0:
            errs.append("flight_recompile_window_s must be > 0")
        if self.flight_events_tail < 1:
            errs.append("flight_events_tail must be >= 1")
        if not (0 < self.journey_tol < 1):
            errs.append("journey_tol must be in (0, 1) — a fraction "
                        "of wall clock the hop sum may miss by")
        if not self.fleet_flight_dir.strip():
            errs.append("fleet_flight_dir must be a non-empty path")
        if self.fleet_flight_max_bundles < 1:
            errs.append("fleet_flight_max_bundles must be >= 1")
        if self.fleet_flight_min_interval_s < 0:
            errs.append("fleet_flight_min_interval_s must be >= 0")
        if self.fleet_flight_failover_burst < 2:
            errs.append("fleet_flight_failover_burst must be >= 2 "
                        "(one failover is an event, not an incident)")
        if self.fleet_flight_window_s <= 0:
            errs.append("fleet_flight_window_s must be > 0")
        if self.watchdog_cancel_stall_s < self.watchdog_token_stall_s:
            # Cancellation cannot precede detection; a smaller value
            # would silently mean max(token, cancel) (watchdog.py).
            errs.append("watchdog_cancel_stall_s must be >= "
                        "watchdog_token_stall_s")
        if errs:
            raise ValueError("Invalid configuration:\n  " + "\n  ".join(errs))
        if self.kv_host_budget_mb > 0:
            # Warn (do not fail) when the budget exceeds the host's RAM: the
            # pool would page or be killed long before it fills.
            try:
                import psutil

                total_mb = psutil.virtual_memory().total / (1024 * 1024)
                if self.kv_host_budget_mb > total_mb:
                    import logging

                    logging.getLogger("fasttalk.config").warning(
                        "KV_HOST_BUDGET_MB=%.0f exceeds detectable "
                        "host RAM (%.0f MB); the pool will hit swap "
                        "or the OOM killer before its budget",
                        self.kv_host_budget_mb, total_mb)
            except Exception:
                pass

    @property
    def mesh_size(self) -> int:
        """Ranks the mesh spans (tp x dp x sp)."""
        return max(1, self.tp_size) * max(1, self.dp_size) \
            * max(1, self.sp_size)

    @staticmethod
    def process_group_configured() -> bool:
        """Whether the environment configures the process group
        (parallel/distributed.py ``maybe_initialize``)."""
        return bool(os.environ.get("TPU_COORDINATOR_ADDR")
                    and os.environ.get("TPU_NUM_PROCESSES"))

    def to_dict(self) -> dict[str, Any]:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)
