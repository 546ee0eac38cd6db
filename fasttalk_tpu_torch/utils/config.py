"""Environment-driven configuration of the port's serving slice.

The subset of ``fasttalk_tpu/utils/config.py`` that the WebSocket serving
path reads, under the same environment names. Features of the JAX package
that this slice does not carry (speculative decoding, host KV offload,
paged or int8 KV, the radix cache, structured decoding, int4 weights, a
device mesh) are rejected with a named error when their variable asks for
them; they are never silently ignored.

The device is not configuration: it is an argument of the entry points
(``resolve_device``), ``cuda`` unless the caller asks for the CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch


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


# Variables of features outside this slice: (env name, value that keeps the
# feature off, what to tell the operator).
_OUT_OF_SLICE = (
    ("TPU_SPEC_DECODE", ("off", ""), "speculative decoding"),
    ("KV_QUANT", ("none", ""), "the int8 KV-cache tier"),
    ("KV_LAYOUT", ("dense", ""), "the paged KV tier"),
    ("STRUCTURED_MODE", ("auto", "off", ""), "structured decoding"),
)


@dataclass
class Config:
    """Serving settings, each overridable via its environment variable."""

    model_name: str = field(default_factory=lambda: _env_str("LLM_MODEL", "llama3.2:1b"))
    model_path: str = field(default_factory=lambda: _env_str("MODEL_PATH", "/app/models"))
    decode_slots: int = field(default_factory=lambda: _env_int("TPU_DECODE_SLOTS", 16))
    max_model_len: int = field(default_factory=lambda: _env_int("TPU_MAX_MODEL_LEN", 8192))
    prefill_chunk: int = field(default_factory=lambda: _env_int("TPU_PREFILL_CHUNK", 512))
    decode_steps_per_call: int = field(
        default_factory=lambda: _env_int("TPU_DECODE_STEPS", 32))
    pipeline_depth: int = field(
        default_factory=lambda: _env_int("TPU_PIPELINE_DEPTH", 2))
    # WEIGHT_QUANT wins; TPU_QUANTIZE is its legacy alias.
    weight_quant: str = field(default_factory=lambda: _env_str(
        "WEIGHT_QUANT", {"none": "off"}.get(_env_str("TPU_QUANTIZE", "none"),
                                           _env_str("TPU_QUANTIZE", "none"))))
    dtype: str = field(default_factory=lambda: _env_str("TPU_DTYPE", "bfloat16"))
    host: str = field(default_factory=lambda: _env_str("LLM_HOST", "0.0.0.0"))
    port: int = field(default_factory=lambda: _env_int("LLM_PORT", 8000))
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
        default_factory=lambda: _env_float("DEFAULT_REPEAT_PENALTY", 1.1))
    session_timeout: int = field(default_factory=lambda: _env_int("SESSION_TIMEOUT", 3600))

    def __post_init__(self) -> None:
        errs: list[str] = []
        for name, off_values, what in _OUT_OF_SLICE:
            raw = os.getenv(name, "").strip().lower()
            if raw not in off_values:
                errs.append(f"{name}={raw} asks for {what}: not "
                            "implemented yet in fasttalk_tpu_torch")
        if _env_float("KV_HOST_BUDGET_MB", 0.0) > 0:
            errs.append("KV_HOST_BUDGET_MB>0 asks for the host KV-offload "
                        "tier: not implemented yet in fasttalk_tpu_torch")
        if _env_bool("KV_RADIX_ENABLED", False):
            errs.append("KV_RADIX_ENABLED=true asks for the radix prefix "
                        "cache: not implemented yet in fasttalk_tpu_torch")
        for name in ("TPU_TP_SIZE", "TPU_DP_SIZE", "TPU_SP_SIZE"):
            if _env_int(name, 1) != 1:
                errs.append(f"{name}>1 asks for a device mesh: not "
                            "implemented yet in fasttalk_tpu_torch")
        if self.weight_quant not in ("off", "int8"):
            errs.append(f"WEIGHT_QUANT must be off|int8 in fasttalk_tpu_torch "
                        f"(int4: not implemented yet), got "
                        f"{self.weight_quant!r}")
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
        if errs:
            raise ValueError("Invalid configuration:\n  " + "\n  ".join(errs))

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)
