"""Int8 weight-only quantization for serving.

Counterpart of ``fasttalk_tpu/ops/quant.py``, same format: a quantized
leaf is the dict ``{"q": int8[..., in, out], "s": float32[..., out]}``
(per-output-channel scales); the embedding quantizes per ROW
(``{"q": int8[V, D], "s": float32[V]}``) because its rows are both the
gathered input embeddings and the output channels of the tied lm_head;
an untied lm_head is stored transposed, ``{"qt": int8[V, D], "s": [V]}``.

Decode (T=1) matmuls on a CUDA tensor run the hand-written kernels of
``ops/cuda_int8.py``; prefill (T>1) stays ``(x @ q.to(x.dtype)) * s`` via
``torch.matmul``, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import Any

import torch

from fasttalk_tpu_torch.ops.cuda_int8 import int8_matmul, int8_matmul_t

# Matmul weights quantized per OUTPUT channel (scale over the contraction
# axis). Norms/biases stay in the activation dtype.
QUANTIZED_LEAVES = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"})
EMBED_LEAF = "embed"


def quantize_math_out(wf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 (scale over axis -2). Rounding is
    half to even, as ``jnp.round``, so both packages give the same bytes."""
    s = torch.clamp(wf.abs().amax(dim=-2) / 127.0, min=1e-8)
    return torch.round(wf / s[..., None, :]).to(torch.int8), s


def quantize_math_row(wf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 (scale over axis -1; the embedding)."""
    s = torch.clamp(wf.abs().amax(dim=-1) / 127.0, min=1e-8)
    return torch.round(wf / s[..., None]).to(torch.int8), s


def _quantize_stacked(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """Layer by layer, so only one layer's f32 copy exists at a time."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty(w.shape[:-2] + w.shape[-1:], dtype=torch.float32,
                    device=w.device)
    for i in range(w.shape[0]):
        q[i], s[i] = quantize_math_out(w[i].to(torch.float32))
    return {"q": q, "s": s}


def quantize_params(params: dict) -> dict:
    """Quantize the matmul weights of a param dict (leaf by leaf; the
    input leaves are dropped from the returned dict)."""
    out = dict(params)
    out["layers"] = dict(params["layers"])
    for name in list(out["layers"]):
        if name in QUANTIZED_LEAVES:
            out["layers"][name] = _quantize_stacked(out["layers"][name])
    if "lm_head" in out:
        qt, s = quantize_math_row(out["lm_head"].T.to(torch.float32))
        out["lm_head"] = {"qt": qt, "s": s}
    q, s = quantize_math_row(out["embed"].to(torch.float32))
    out["embed"] = {"q": q, "s": s}
    return out


def matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` for a plain or int8 weight leaf; x is [B, T, in]."""
    if isinstance(w, dict):
        if "qt" in w:
            if x.dim() == 3 and x.shape[1] == 1:
                return int8_matmul_t(x[:, 0], w["qt"], w["s"])[:, None]
            out = x @ w["qt"].to(x.dtype).T
            return out * w["s"].to(x.dtype)
        if x.dim() == 3 and x.shape[1] == 1:
            return int8_matmul(x[:, 0].contiguous(), w["q"], w["s"])[:, None]
        return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)
    return x @ w


def embed_lookup(emb: Any, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """Input-embedding gather for a plain or row-quantized table."""
    if isinstance(emb, dict):
        rows = emb["q"][tokens].to(torch.float32)
        return (rows * emb["s"][tokens][..., None]).to(dtype)
    return emb[tokens]


def matmul_tied(x: torch.Tensor, emb: Any) -> torch.Tensor:
    """``x @ embed.T`` — the tied-embedding lm_head ([.., D] @ [V, D].T)."""
    if isinstance(emb, dict):
        if x.dim() == 3 and x.shape[1] == 1:
            return int8_matmul_t(x[:, 0].contiguous(), emb["q"],
                                 emb["s"])[:, None]
        return (x @ emb["q"].to(x.dtype).T) * emb["s"].to(x.dtype)
    return x @ emb.T
