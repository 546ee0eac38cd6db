"""Activation-aware int4 scale search (AWQ-style) for the int4 tier.

Counterpart of ``fasttalk_tpu/quantization/awq.py``, same searches, grids
and results. Data-free group quantization (int4.py) spends its 16 codes
uniformly over each group's range, but a few input channels carry most of
the activation magnitude, and rounding those coarsely is what moves the
logits. Two moves re-balance the codes, searched per layer against a
calibration batch:

1. **Norm-fold channel scaling** for the matmuls fed by an RMSNorm (wq/wk/wv
   after attn_norm; w_gate/w_up after mlp_norm): per input channel j,
   ``s_j = mean|h_j| ** alpha`` (geometric-mean normalised) multiplies the
   weight rows before quantization and divides the norm's gain, exact in
   float; alpha is grid-searched per layer group to minimise output MSE
   against the float matmul on the calibration activations.
2. **Clip search** for the matmuls with no foldable norm upstream (wo,
   w_down): each group's maxabs shrinks by ``c <= 1``, grid-searched the
   same way.

The calibration forward runs layer by layer in float32 with the original
weights, through the port's own ``rms_norm``, ``apply_rope`` and
``attend``, on whatever device the params are on. The embedding and
lm_head keep their int8 formats. Offline entry point: ``python -m
fasttalk_tpu_torch quantize``, which writes the result into the prepared
cache the factory restores.
"""

from __future__ import annotations

from typing import Any

import torch

from fasttalk_tpu_torch.quantization.int4 import (pack_int4,
                                                  quantize_math_group,
                                                  unpack_int4)
from fasttalk_tpu_torch.utils.logger import get_logger

log = get_logger("quantization.awq")

# Alpha grid of the norm-fold search; 0.0 is the data-free identity, so AWQ
# never does worse than the fallback on its own objective.
ALPHA_GRID = tuple(i / 10.0 for i in range(11))
# Clip grid for wo/w_down; 1.0 is the data-free identity.
CLIP_GRID = (1.0, 0.95, 0.9, 0.85, 0.8)
# Calibration rows used for the per-candidate output-MSE evaluations (the
# whole batch feeds the channel statistics).
_EVAL_ROWS = 512


def calibration_tokens(tokenizer: Any, *, n_samples: int = 16,
                       seq_len: int = 256, seed: int = 0,
                       source: str = "corpus") -> torch.Tensor:
    """[n, seq_len] int64 calibration batch (on the CPU).

    ``source``: "corpus" draws rendered tinychat training conversations
    (training/corpus.py); any other value is a UTF-8 text file whose
    non-empty lines are the documents. Token streams are packed
    (concatenated, then cut into rows), never padded."""
    if source in ("", "corpus"):
        from fasttalk_tpu_torch.training.corpus import corpus_texts

        texts = list(corpus_texts(max(n_samples * 2, 8), seed))
    else:
        with open(source, encoding="utf-8") as f:
            texts = [ln for ln in (line.strip() for line in f) if ln]
        if not texts:
            raise ValueError(
                f"WEIGHT_QUANT_CALIB file {source!r} has no non-empty "
                "lines to calibrate on")
    stream: list[int] = []
    need = n_samples * seq_len
    for text in texts:
        stream.extend(tokenizer.encode(text))
        if len(stream) >= need:
            break
    n = min(n_samples, len(stream) // seq_len)
    if n < 1:
        raise ValueError(
            f"calibration source yielded only {len(stream)} tokens; "
            f"need at least seq_len={seq_len} for one sample")
    return torch.tensor(stream[:n * seq_len], dtype=torch.int64).reshape(
        n, seq_len)


def _dequant_candidate(w: torch.Tensor, group: int,
                       clip: float = 1.0) -> torch.Tensor:
    """Quantize-dequantize ``w`` [K, N] f32 with the group's maxabs shrunk
    by ``clip``: what a served int4 leaf would compute."""
    k, n = w.shape
    g = w.reshape(k // group, group, n)
    s = torch.clamp(g.abs().amax(dim=-2) * clip / 7.0, min=1e-8)
    q = torch.clamp(torch.round(g / s[:, None, :]), -8, 7)
    return (q * s[:, None, :]).reshape(k, n)


def _fold_search(h: torch.Tensor, weights: dict[str, torch.Tensor],
                 group: int) -> tuple[float, torch.Tensor]:
    """Best (alpha, s) for one norm-fed weight group: the summed output MSE
    of ``(h/s) @ dq(s*W)`` against ``h @ W`` over ``h`` [rows, K] f32 and
    ``weights`` name -> [K, out]."""
    m = torch.clamp(h.abs().mean(dim=0), min=1e-8)
    he = h[:_EVAL_ROWS]
    refs = {name: he @ w for name, w in weights.items()}
    best = (float("inf"), 0.0, torch.ones_like(m))
    for alpha in ALPHA_GRID:
        s = m ** alpha
        s = s / torch.exp(torch.log(s).mean())  # geo-mean 1: pure re-balance
        s = torch.clamp(s, min=1e-4)
        err = 0.0
        hs = he / s[None, :]
        for name, w in weights.items():
            dq = _dequant_candidate(w * s[:, None], group)
            err += float(((hs @ dq - refs[name]) ** 2).mean())
        if err < best[0]:
            best = (err, alpha, s)
    return best[1], best[2]


def _clip_search(h: torch.Tensor, w: torch.Tensor, group: int) -> float:
    """Best maxabs-shrink factor for one norm-less weight [K, out]."""
    he = h[:_EVAL_ROWS]
    ref = he @ w
    best = (float("inf"), 1.0)
    for clip in CLIP_GRID:
        err = float(((he @ _dequant_candidate(w, group, clip) - ref) ** 2
                     ).mean())
        if err < best[0]:
            best = (err, clip)
    return best[1]


def _quantize_clipped(w: torch.Tensor, group: int, clip: float) -> dict:
    """Pack [..., K, N] with the group maxabs shrunk by ``clip``."""
    if clip >= 1.0:
        q, s = quantize_math_group(w, group)
        return {"q4": pack_int4(q), "s": s}
    k, n = w.shape[-2], w.shape[-1]
    g = w.to(torch.float32).reshape(w.shape[:-2] + (k // group, group, n))
    s = torch.clamp(g.abs().amax(dim=-2) * clip / 7.0, min=1e-8)
    q = torch.clamp(torch.round(g / s[..., None, :]), -8, 7).to(torch.int8)
    return {"q4": pack_int4(q.reshape(w.shape[:-2] + (k, n))), "s": s}


def quantize_params_awq(params: dict, cfg: Any, tokens: torch.Tensor,
                        group: int) -> tuple[dict, dict]:
    """AWQ-calibrated int4 quantization of a FLOAT param dict.

    ``params``: unquantized dict (models/loader.py layout, any float dtype);
    ``tokens`` [B, T] from :func:`calibration_tokens`. Returns (quantized
    dict, manifest with the chosen alpha/clip per layer), the manifest
    being what the quantize command writes beside the prepared cache."""
    from fasttalk_tpu_torch.models.llama import rms_norm
    from fasttalk_tpu_torch.ops.attention import attend
    from fasttalk_tpu_torch.ops.quant import quantize_embed, quantize_head_t
    from fasttalk_tpu_torch.ops.rope import apply_rope, rope_frequencies

    group = int(group)
    layers = params["layers"]
    dev = params["embed"].device
    tokens = tokens.to(dev).long()
    b, t = tokens.shape
    positions = torch.arange(t, device=dev)[None, :].expand(b, t)
    inv_freq = torch.as_tensor(rope_frequencies(
        cfg.head_dim, cfg.rope_theta, cfg.rope_scaling), device=dev)
    x = params["embed"].to(torch.float32)[tokens]
    out_layers: dict[str, list] = {
        name: [] for name in ("attn_norm", "mlp_norm", "wq", "wk", "wv",
                              "wo", "w_gate", "w_up", "w_down")}
    manifest: dict[str, Any] = {"group": group, "layers": []}
    for li in range(cfg.num_layers):
        lp = {name: w[li].to(torch.float32) for name, w in layers.items()}
        # Attention block, float forward with the original weights.
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q = h @ lp["wq"]
        k = h @ lp["wk"]
        v = h @ lp["wv"]
        if cfg.qkv_bias:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        q = apply_rope(q.reshape(b, t, cfg.num_heads, cfg.head_dim),
                       positions, inv_freq)
        k = apply_rope(k.reshape(b, t, cfg.num_kv_heads, cfg.head_dim),
                       positions, inv_freq)
        v = v.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
        o = attend(q, k, v, positions).reshape(b, t, cfg.q_dim)
        x = x + o @ lp["wo"]
        # MLP block.
        h2 = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        gate = torch.nn.functional.silu(h2 @ lp["w_gate"])
        up = h2 @ lp["w_up"]
        prod = gate * up
        x = x + prod @ lp["w_down"]

        # Searches on this layer's captured activations.
        a_attn, s_attn = _fold_search(
            h.reshape(-1, cfg.hidden_size),
            {n: lp[n] for n in ("wq", "wk", "wv")}, group)
        a_mlp, s_mlp = _fold_search(
            h2.reshape(-1, cfg.hidden_size),
            {n: lp[n] for n in ("w_gate", "w_up")}, group)
        c_wo = _clip_search(o.reshape(-1, cfg.q_dim), lp["wo"], group)
        c_down = _clip_search(prod.reshape(-1, cfg.intermediate_size),
                              lp["w_down"], group)
        for name, s in (("wq", s_attn), ("wk", s_attn), ("wv", s_attn),
                        ("w_gate", s_mlp), ("w_up", s_mlp)):
            out_layers[name].append(
                _quantize_clipped(lp[name] * s[:, None], group, 1.0))
        out_layers["attn_norm"].append(lp["attn_norm"] / s_attn)
        out_layers["mlp_norm"].append(lp["mlp_norm"] / s_mlp)
        out_layers["wo"].append(_quantize_clipped(lp["wo"], group, c_wo))
        out_layers["w_down"].append(
            _quantize_clipped(lp["w_down"], group, c_down))
        manifest["layers"].append({
            "layer": li, "alpha_attn": float(a_attn),
            "alpha_mlp": float(a_mlp), "clip_wo": float(c_wo),
            "clip_w_down": float(c_down)})
        log.info(f"AWQ layer {li}: alpha_attn={a_attn:.1f} "
                 f"alpha_mlp={a_mlp:.1f} clip_wo={c_wo:.2f} "
                 f"clip_w_down={c_down:.2f}")

    norm_dtype = params["layers"]["attn_norm"].dtype
    out = dict(params)
    out["layers"] = dict(params["layers"])
    for name, per_layer in out_layers.items():
        if isinstance(per_layer[0], dict):
            out["layers"][name] = {
                "q4": torch.stack([d["q4"] for d in per_layer]),
                "s": torch.stack([d["s"] for d in per_layer])}
        else:
            out["layers"][name] = torch.stack(per_layer).to(norm_dtype)
    out["embed"] = quantize_embed(params["embed"])
    if "lm_head" in out:
        out["lm_head"] = quantize_head_t(params["lm_head"])
    return out, manifest


def dequant_error(w4: dict, wf: torch.Tensor) -> float:
    """Mean-squared weight reconstruction error (tests, manifests)."""
    group = (2 * w4["q4"].shape[-2]) // w4["s"].shape[-2]
    dq = unpack_int4(w4["q4"]).to(torch.float32) * w4["s"].to(
        torch.float32).repeat_interleave(group, dim=-2)
    return float(((dq - wf.to(torch.float32)) ** 2).mean())
