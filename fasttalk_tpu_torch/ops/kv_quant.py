"""Int8 KV-cache quantization: per-row symmetric scales.

Counterpart of ``fasttalk_tpu/ops/kv_quant.py`` (``granule_dim`` :47,
``kv_quantize`` :55, ``kv_dequantize`` :69), with the same arithmetic:
f32 max-abs, ``s = max(amax / 127, 1e-8)``, round half to even
(``torch.round``, as ``jnp.round``), clip to +-127.

Scale granularity (``KV_QUANT_GRANULE``): ``token`` keeps one f32 scale
per K/V row (max-abs over the whole [Kv, H] row, G = 1), ``head`` one per
KV head of the row (max-abs over [H], G = Kv). Scales carry a trailing
granule axis ``G``, so ``q * s[..., None]`` broadcasts either shape
against a [..., Kv, H] row block.
"""

from __future__ import annotations

import torch

# Below this magnitude a row is effectively zero; the floor keeps the
# divide finite and quantizes such rows to exact zeros.
_EPS = 1e-8

GRANULES = ("token", "head")


def granule_dim(granule: str, num_kv_heads: int) -> int:
    """Scale-axis length G for a granule name."""
    if granule not in GRANULES:
        raise ValueError(f"KV_QUANT_GRANULE must be one of {GRANULES}, "
                         f"got {granule!r}")
    return num_kv_heads if granule == "head" else 1


def kv_quantize(x: torch.Tensor, g: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K/V rows ``x`` [..., Kv, H] -> (int8 rows, f32 scales [..., G]),
    symmetric per-row max-abs scales; ``g`` is 1 or Kv."""
    xf = x.to(torch.float32)
    if g == 1:
        amax = xf.abs().amax(dim=(-2, -1))[..., None]
    else:
        amax = xf.abs().amax(dim=-1)
    s = torch.clamp(amax / 127.0, min=_EPS)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def kv_dequantize(q: torch.Tensor, s: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """int8 rows [..., Kv, H] x scales [..., G] -> ``dtype`` rows."""
    return (q.to(torch.float32) * s[..., None]).to(dtype)
