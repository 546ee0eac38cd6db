"""Int8 weight-only quantization for serving.

Counterpart of ``fasttalk_tpu/ops/quant.py``, same format: a quantized
leaf is the dict ``{"q": int8[..., in, out], "s": float32[..., out]}``
(per-output-channel scales); the embedding quantizes per ROW
(``{"q": int8[V, D], "s": float32[V]}``) because its rows are both the
gathered input embeddings and the output channels of the tied lm_head;
an untied lm_head is stored transposed, ``{"qt": int8[V, D], "s": [V]}``.
The int4 tier's leaves ``{"q4": uint8[..., in/2, out], "s": f32[...,
in/G, out]}`` (fasttalk_tpu_torch/quantization/int4.py) take the seven
layer matmuls.

Decode matmuls (a T=1 step, and the speculative verify block, whose
[B, T, in] activations go in as [B*T, in] rows: ``decode=True``) run the
hand-written kernels of ``ops/cuda_int8.py`` and ``ops/cuda_int4.py``;
prefill (T>1) stays ``(x @ q.to(x.dtype)) * s`` (int8) or the dequantized
product (int4) via ``torch.matmul``, as the JAX package leaves it to XLA.
On a "tp" mesh the row-parallel matmuls take ``row_parallel``.
"""

from __future__ import annotations

from typing import Any

import torch

from fasttalk_tpu_torch.ops.cuda_int4 import int4_matmul
from fasttalk_tpu_torch.ops.cuda_int8 import int8_matmul, int8_matmul_t
from fasttalk_tpu_torch.quantization.int4 import unpack_int4

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


def quantize_embed(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-row int8 for the embedding table [V, D]."""
    q, s = quantize_math_row(w.to(torch.float32))
    return {"q": q, "s": s}


def quantize_head_t(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """The untied lm_head [D, V], stored transposed: ``{"qt": int8[V, D],
    "s": f32[V]}`` (the layout ``int8_matmul_t`` streams)."""
    qt, s = quantize_math_row(w.T.to(torch.float32))
    return {"qt": qt.contiguous(), "s": s}


def quantize_params(params: dict) -> dict:
    """Quantize the matmul weights of a param dict (leaf by leaf; the
    input leaves are dropped from the returned dict)."""
    out = dict(params)
    out["layers"] = dict(params["layers"])
    for name in list(out["layers"]):
        if name in QUANTIZED_LEAVES:
            out["layers"][name] = _quantize_stacked(out["layers"][name])
    if "lm_head" in out:
        out["lm_head"] = quantize_head_t(out["lm_head"])
    out["embed"] = quantize_embed(out["embed"])
    return out


def _dequant_int4(x: torch.Tensor, w: dict) -> torch.Tensor:
    group = (2 * w["q4"].shape[-2]) // w["s"].shape[-2]
    wd = unpack_int4(w["q4"]).to(x.dtype)
    return x @ (wd * w["s"].to(x.dtype).repeat_interleave(group, -2))


def _kernel_rows(x: torch.Tensor, w: dict) -> torch.Tensor:
    """The decode route: x [M, in] rows through the int8/int4 kernels (on
    the CPU their plain versions; int4 takes the dequantized product
    there, as the JAX package's XLA path does)."""
    x = x.contiguous()
    if "q4" in w:
        return int4_matmul(x, w["q4"], w["s"]) if x.is_cuda \
            else _dequant_int4(x, w)
    if "qt" in w:
        return int8_matmul_t(x, w["qt"], w["s"])
    return int8_matmul(x, w["q"], w["s"])


def _decode_route(x: torch.Tensor, decode: bool) -> bool:
    return decode or (x.dim() == 3 and x.shape[1] == 1)


def matmul(x: torch.Tensor, w: Any, decode: bool = False) -> torch.Tensor:
    """``x @ w`` for a plain, int8 or int4 weight leaf; x is [B, T, in].
    A quantized leaf takes the kernels for a T=1 step or when ``decode``
    is set (the verify block), the dequantized product otherwise."""
    if isinstance(w, dict):
        if _decode_route(x, decode):
            b, t = x.shape[:2]
            return _kernel_rows(x.reshape(b * t, x.shape[-1]),
                                w).view(b, t, -1)
        if "q4" in w:
            return _dequant_int4(x, w)
        if "qt" in w:
            out = x @ w["qt"].to(x.dtype).T
            return out * w["s"].to(x.dtype)
        return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)
    return x @ w


def row_parallel(x: torch.Tensor, w: Any, reduce, decode: bool = False,
                 tied: bool = False) -> torch.Tensor:
    """A row-parallel shard's product summed over the ranks, rounded as
    the unsharded product is. ``x`` [B, T, in/tp] holds this rank's
    columns of the activations and ``w`` its rows of a plain or int8 layer
    weight (``tied``: its columns of the [V, D] embedding table). Each
    partial product stays float32 (the int8 kernels' ``out_dtype``),
    ``reduce`` sums the partials over the ranks, and the sum is rounded
    where ``matmul``/``matmul_tied`` round one rank's whole product: the
    two differ only by the order of float32 additions."""
    f32 = torch.float32
    if not isinstance(w, dict):
        wf = w.to(f32)
        return reduce(x.to(f32) @ (wf.T if tied else wf)).to(x.dtype)
    if "q" not in w:
        raise ValueError("row_parallel: int8 leaves only (int4 and an "
                         "untied head are not row-parallel on a mesh)")
    if _decode_route(x, decode):
        b, t = x.shape[:2]
        rows = x.reshape(b * t, x.shape[-1]).contiguous()
        kernel = int8_matmul_t if tied else int8_matmul
        part = kernel(rows, w["q"], w["s"], out_dtype=f32)
        return reduce(part).to(x.dtype).view(b, t, -1)
    q = w["q"].to(f32)
    part = x.to(f32) @ (q.T if tied else q)
    return reduce(part).to(x.dtype) * w["s"].to(x.dtype)


def embed_lookup(emb: Any, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """Input-embedding gather for a plain or row-quantized table."""
    if isinstance(emb, dict):
        rows = emb["q"][tokens].to(torch.float32)
        return (rows * emb["s"][tokens][..., None]).to(dtype)
    return emb[tokens]


def matmul_tied(x: torch.Tensor, emb: Any,
                decode: bool = False) -> torch.Tensor:
    """``x @ embed.T`` — the tied-embedding lm_head ([.., D] @ [V, D].T);
    a quantized table takes ``int8_matmul_t`` on the decode route."""
    if isinstance(emb, dict):
        if _decode_route(x, decode):
            b, t = x.shape[:2]
            return int8_matmul_t(x.reshape(b * t, x.shape[-1]).contiguous(),
                                 emb["q"], emb["s"]).view(b, t, -1)
        return (x @ emb["q"].to(x.dtype).T) * emb["s"].to(x.dtype)
    return x @ emb.T
