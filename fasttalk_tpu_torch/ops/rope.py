"""Rotary position embeddings with Llama-3 frequency scaling.

Counterpart of ``fasttalk_tpu/ops/rope.py``: the inverse frequencies are
host-computed in numpy (float64, then float32) exactly as there, and the
rotation runs in float32 regardless of the activation dtype.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:
    from fasttalk_tpu_torch.models.configs import RopeScaling


def rope_frequencies(head_dim: int, theta: float,
                     scaling: "RopeScaling | None") -> np.ndarray:
    """Per-pair inverse frequencies [head_dim/2], float32, host-computed."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    if scaling is not None:
        # Llama-3 rope scaling: keep high-frequency (short wavelength)
        # components, scale low-frequency ones by 1/factor, smooth between.
        low_wl = scaling.original_max_position / scaling.low_freq_factor
        high_wl = scaling.original_max_position / scaling.high_freq_factor
        wavelen = 2.0 * np.pi / inv_freq
        smooth = (scaling.original_max_position / wavelen - scaling.low_freq_factor) / (
            scaling.high_freq_factor - scaling.low_freq_factor)
        smooth = np.clip(smooth, 0.0, 1.0)
        scaled = inv_freq / scaling.factor
        blended = (1.0 - smooth) * scaled + smooth * inv_freq
        inv_freq = np.where(wavelen > low_wl, scaled,
                            np.where(wavelen < high_wl, inv_freq, blended))
    return inv_freq.astype(np.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` [..., T, H, D] by ``positions`` [..., T].

    Pairs are (x[..., :D/2], x[..., D/2:]) — the HF Llama "rotate_half"
    convention. ``inv_freq`` is the float32 tensor of ``rope_frequencies``
    on x's device.
    """
    angles = positions[..., :, None].to(torch.float32) * inv_freq  # [..., T, D/2]
    cos = torch.cos(angles)[..., None, :]  # [..., T, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    half = x.shape[-1] // 2
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)
