"""The optimizer and the learning-rate schedule of training: the port's
``optax.adamw`` and ``optax.warmup_cosine_decay_schedule``.

The JAX package takes both from optax; the port keeps optax's constants,
formulas and order of operations, so the two hold to each other step by
step (not torch's ``AdamW`` defaults: its weight decay is 1e-2, optax's
1e-4):

- ``scale_by_adam``: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 +
  b2 nu``, bias corrections ``1 - b^t`` in float32 (t counts from 1),
  ``u = mu_hat / (sqrt(nu_hat + eps_root) + eps)``; the moments are kept
  in the params' dtype (optax's ``zeros_like``);
- ``add_decayed_weights``: ``u + weight_decay * p``;
- ``scale_by_learning_rate``: ``u * -lr``, ``lr`` a constant or a schedule
  of the step count (0 for the first update);
- ``apply_updates``: ``p + u`` in the param's dtype, here in place.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

Schedule = Callable[[int], float]


def _zeros_like(tree: dict) -> dict:
    return {k: _zeros_like(v) if isinstance(v, dict)
            else torch.zeros_like(v) for k, v in tree.items()}


def _at(tree: dict, path: tuple) -> torch.Tensor:
    for k in path:
        tree = tree[k]
    return tree


class AdamW:
    """``optax.adamw``: ``init(params) -> state`` and ``update(grads,
    state, params)``, which applies the update to ``params`` and the
    moments of ``state`` in place. ``grads`` holds every leaf's gradient,
    keyed by its path (the tuple of keys from the root, as
    ``parallel/train.value_and_grad`` gives it)."""

    def __init__(self, learning_rate: float | Schedule, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
                 weight_decay: float = 1e-4):
        self.learning_rate = learning_rate
        self.b1, self.b2 = b1, b2
        self.eps, self.eps_root = eps, eps_root
        self.weight_decay = weight_decay

    def init(self, params: dict) -> dict:
        return {"count": 0, "mu": _zeros_like(params),
                "nu": _zeros_like(params)}

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def update(self, grads: dict, state: dict, params: dict) -> None:
        b1, b2 = self.b1, self.b2
        step_size = -self.lr(state["count"])
        t = np.float32(state["count"] + 1)
        # 1 - decay**count in float32, then cast to each moment's dtype.
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        with torch.no_grad():
            for path, g in grads.items():
                p = _at(params, path)
                mu, nu = _at(state["mu"], path), _at(state["nu"], path)
                mu.copy_((1 - b1) * g + b1 * mu)
                nu.copy_((1 - b2) * (g * g) + b2 * nu)
                mu_hat = mu / torch.tensor(bc1, dtype=mu.dtype)
                nu_hat = nu / torch.tensor(bc2, dtype=nu.dtype)
                u = mu_hat / (torch.sqrt(nu_hat + self.eps_root) + self.eps)
                u = u + self.weight_decay * p
                u = u * torch.tensor(step_size, dtype=u.dtype)
                p.copy_(p + u)
        state["count"] += 1


def adamw(learning_rate: float | Schedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0,
          weight_decay: float = 1e-4) -> AdamW:
    """``optax.adamw`` with its defaults."""
    return AdamW(learning_rate, b1, b2, eps, eps_root, weight_decay)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then cosine down to
    ``end_value`` at ``decay_steps`` (counted from step 0), flat after."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if not cos_steps > 0:
        raise ValueError(
            'The cosine_decay_schedule requires positive decay_steps, got'
            f' decay_steps={cos_steps}.')

    def warmup(count: float) -> float:
        if warmup_steps <= 0:
            return init_value
        frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
        return (init_value - peak_value) * frac + peak_value

    def cosine(count: float) -> float:
        count = min(count, cos_steps)
        decay = 0.5 * (1 + math.cos(math.pi * count / cos_steps))
        return peak_value * ((1 - alpha) * decay ** exponent + alpha)

    def schedule(count: int) -> float:
        return float(np.float32(warmup(count) if count < warmup_steps
                                else cosine(count - warmup_steps)))

    return schedule


__all__ = ["AdamW", "adamw", "warmup_cosine_decay_schedule"]
