"""Batched sampling: temperature / top-k / top-p per slot, on the device.

Counterpart of ``fasttalk_tpu/ops/sampling.py``: restrict to the top
``max_candidates`` logits (sorted), apply per-slot top-k and top-p masks
inside that candidate set, then draw one token per row. Randomness comes
from an explicit ``torch.Generator`` (Gumbel-max over the kept
candidates), so sampled streams match the JAX package in distribution,
not token for token; greedy rows (temperature <= 1e-4) are exact.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30
_BLOCK = 128  # candidate-preselection block width


def apply_penalties(logits: torch.Tensor, counts: torch.Tensor,
                    repeat: torch.Tensor, presence: torch.Tensor,
                    frequency: torch.Tensor) -> torch.Tensor:
    """Repetition / presence / frequency penalties against per-row
    emitted-token counts [B, V], applied to the full logits row.
    repeat/presence/frequency are [B]. Returns float32 logits."""
    return penalize_values(logits.to(torch.float32),
                           counts.to(torch.float32), repeat[:, None],
                           presence[:, None], frequency[:, None])


def penalize_values(lg: torch.Tensor, counts_f: torch.Tensor,
                    repeat: torch.Tensor, presence: torch.Tensor,
                    frequency: torch.Tensor) -> torch.Tensor:
    """The penalty formula on float tensors of any ranks that broadcast
    together (``fasttalk_tpu/ops/sampling.py::penalize_values`` :62). The
    speculative verify block penalises its [S, T, V] logits against the
    [S, 1, V] base counts with it, then re-applies it to the few draft
    entries whose within-block counts differ."""
    seen = counts_f > 0
    rep = torch.where(seen, repeat, torch.ones_like(repeat))
    lg = torch.where(lg > 0, lg / rep, lg * rep)
    return lg - presence * seen.to(torch.float32) - frequency * counts_f


def _select_candidates(logits: torch.Tensor, max_candidates: int,
                       method: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Top ``max_candidates`` (values, indices), sorted descending.

    "exact": full-vocab top-k. "fast": block-max preselection — each
    128-wide vocab block contributes its maximum, then top-k over the
    block maxima (greedy top-1 is exact either way)."""
    b, v = logits.shape
    max_candidates = min(max_candidates, v)
    nb = -(-v // _BLOCK)
    if method == "exact" or nb <= max_candidates:
        vals, idx = torch.topk(logits, max_candidates, dim=-1, sorted=True)
        return vals, idx
    if nb * _BLOCK != v:
        logits = torch.nn.functional.pad(logits, (0, nb * _BLOCK - v),
                                         value=_NEG_INF)
    lg3 = logits.reshape(b, nb, _BLOCK)
    bmax, barg = lg3.max(dim=-1)
    top_vals, top_blocks = torch.topk(bmax, max_candidates, dim=-1,
                                      sorted=True)
    top_idx = torch.gather(barg, 1, top_blocks) + top_blocks * _BLOCK
    return top_vals, top_idx


def sample_tokens(logits: torch.Tensor, generator: torch.Generator | None,
                  temperature: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor, max_candidates: int = 64,
                  method: str = "exact") -> torch.Tensor:
    """One token id per row of ``logits`` [B, V] (int64 [B]).

    temperature <= 1e-4 selects greedy argmax for that row (the lowest
    id among equal maxima, as ``jax.lax.top_k`` orders ties); top_k == 0
    disables the top-k filter for that row."""
    b = logits.shape[0]
    max_candidates = min(max_candidates, logits.shape[-1])
    top_vals, top_idx = _select_candidates(logits, max_candidates, method)
    top_vals = top_vals.to(torch.float32)

    ranks = torch.arange(max_candidates, device=logits.device)[None, :]
    k = torch.where(top_k <= 0, torch.full_like(top_k, max_candidates),
                    torch.clamp(top_k, max=max_candidates))
    neg = torch.full_like(top_vals, _NEG_INF)
    vals = torch.where(ranks < k[:, None], top_vals, neg)

    safe_t = torch.clamp(temperature, min=1e-4)[:, None]
    probs = torch.softmax(vals / safe_t, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p[:, None]
    keep[:, 0] = True
    vals = torch.where(keep, vals, neg)

    u = torch.rand(vals.shape, generator=generator, device=vals.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20, max=1.0 - 1e-7)))
    sampled_pos = torch.argmax(vals / safe_t + gumbel, dim=-1)
    sampled = torch.gather(top_idx, 1, sampled_pos[:, None])[:, 0]
    return torch.where(temperature <= 1e-4, logits.argmax(dim=-1), sampled)
