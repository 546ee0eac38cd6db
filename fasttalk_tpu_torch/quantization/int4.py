"""Group-wise symmetric int4 weight format: pack/unpack/quantize math.

Counterpart of ``fasttalk_tpu/quantization/int4.py``, same format and the
same bytes. A matmul leaf ``w: [..., K, N]`` becomes

    {"q4": uint8[..., K/2, N], "s": float32[..., K/G, N]}

* **Symmetric two's-complement nibbles.** Each weight rounds (half to
  even, as ``jnp.round``) to [-8, 7] against a per-(group, out-channel)
  scale ``s = maxabs / 7``; -8 is representable but never produced.
* **Adjacent-pair packing along the contraction axis.** Packed row j holds
  original row 2j in the LOW nibble and row 2j+1 in the HIGH nibble.
* **Group scales along the same axis.** G contraction rows share one f32
  scale per out-channel; G is even (a nibble pair never straddles a group)
  and divides every contraction dim it is applied to (``validate_group``).

Only the seven stacked layer matmuls (``INT4_LEAVES``) go to int4; the
embedding and an untied lm_head keep the int8 tier's per-row / transposed
formats (ops/quant.py), which the lookup and ``int8_matmul_t`` read.
"""

from __future__ import annotations

import torch

# Default contraction-group size; divides every matmul dim of the shipped
# model shapes.
GROUP_DEFAULT = 128

# Stacked per-layer matmul leaves that take the int4 format.
INT4_LEAVES = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"})


def validate_group(model_cfg, group: int) -> None:
    """Raise a named ValueError unless ``group`` fits the model's dims."""
    group = int(group)
    if group < 2 or group % 2:
        raise ValueError(
            f"WEIGHT_QUANT_GROUP must be an even integer >= 2 (int4 packs "
            f"adjacent contraction rows into one byte, so a scale group "
            f"must never split a nibble pair), got {group}")
    dims = {
        "hidden_size (wq/wk/wv/w_gate/w_up contraction)":
            model_cfg.hidden_size,
        "q_dim (wo contraction)": model_cfg.q_dim,
        "intermediate_size (w_down contraction)":
            model_cfg.intermediate_size,
    }
    bad = {name: d for name, d in dims.items() if d % group}
    if bad:
        detail = ", ".join(f"{name}={d}" for name, d in bad.items())
        raise ValueError(
            f"WEIGHT_QUANT_GROUP={group} must divide every matmul "
            f"contraction dim of model '{model_cfg.name}'; it does not "
            f"divide: {detail}. Pick a common divisor (e.g. a power of "
            f"two <= the smallest dim) or use WEIGHT_QUANT=int8.")


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int8 values in [-8, 7] along axis -2, two per byte:
    ``[..., K, N] int8 -> [..., K/2, N] uint8``, packed row j =
    (row 2j+1 << 4) | (row 2j & 0xF)."""
    lo = q[..., 0::2, :].to(torch.uint8) & 0xF
    hi = q[..., 1::2, :].to(torch.uint8) & 0xF
    return (hi << 4) | lo


def unpack_int4(q4: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: ``[..., K/2, N] uint8 -> [..., K, N]
    int8``. The bytes are reinterpreted as int8 (``.view``, as JAX's
    ``astype(int8)`` wraps), whose ``>>`` is arithmetic: ``(b << 4) >> 4``
    sign-extends the low nibble and ``b >> 4`` the high one."""
    b = q4.view(torch.int8)
    lo = (b << 4) >> 4
    hi = b >> 4
    kp, n = q4.shape[-2], q4.shape[-1]
    return torch.stack([lo, hi], dim=-2).reshape(q4.shape[:-2] + (2 * kp, n))


def quantize_math_group(wf: torch.Tensor,
                        group: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Group-wise symmetric quantize ``[..., K, N] -> (q int8, s f32)``,
    ``s[..., g, n] = max|w[..., gG:(g+1)G, n]| / 7`` (clamped away from
    zero), q UNPACKED."""
    k, n = wf.shape[-2], wf.shape[-1]
    g = wf.to(torch.float32).reshape(wf.shape[:-2] + (k // group, group, n))
    s = torch.clamp(g.abs().amax(dim=-2) / 7.0, min=1e-8)
    q = torch.clamp(torch.round(g / s[..., None, :]), -8, 7).to(torch.int8)
    return q.reshape(wf.shape[:-2] + (k, n)), s


def quantize_group(wf: torch.Tensor, group: int) -> dict:
    """Quantize + pack a float leaf into the ``{"q4", "s"}`` format."""
    q, s = quantize_math_group(wf, group)
    return {"q4": pack_int4(q), "s": s}


def group_size_of(w4: dict) -> int:
    """Recover G from a packed leaf's shapes."""
    return (2 * w4["q4"].shape[-2]) // w4["s"].shape[-2]


def dequantize_int4(w4: dict, dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """Materialize the float weight (tests and calibration; serving
    dequantizes inside the matmul, ops/quant.py)."""
    group = group_size_of(w4)
    w = unpack_int4(w4["q4"]).to(dtype)
    return w * w4["s"].to(dtype).repeat_interleave(group, dim=-2)


def _quantize_stacked_int4(w: torch.Tensor, group: int) -> dict:
    """Layer by layer, so only one layer's f32 copy exists at a time."""
    k, n = w.shape[-2], w.shape[-1]
    q4 = torch.empty(w.shape[:-2] + (k // 2, n), dtype=torch.uint8,
                     device=w.device)
    s = torch.empty(w.shape[:-2] + (k // group, n), dtype=torch.float32,
                    device=w.device)
    for i in range(w.shape[0]):
        leaf = quantize_group(w[i], group)
        q4[i], s[i] = leaf["q4"], leaf["s"]
    return {"q4": q4, "s": s}


def quantize_params_int4(params: dict, group: int) -> dict:
    """Data-free quantization of a float param dict: INT4_LEAVES ->
    ``{"q4", "s"}``; the embedding (and untied lm_head) take the int8
    tier's per-row / transposed formats. Calibrated quantization is in
    awq.py."""
    from fasttalk_tpu_torch.ops.quant import quantize_embed, quantize_head_t

    out = dict(params)
    out["layers"] = dict(params["layers"])
    for name, w in out["layers"].items():
        if name in INT4_LEAVES and not isinstance(w, dict):
            out["layers"][name] = _quantize_stacked_int4(w, int(group))
    if not isinstance(out["embed"], dict):
        out["embed"] = quantize_embed(out["embed"])
    if "lm_head" in out and not isinstance(out["lm_head"], dict):
        out["lm_head"] = quantize_head_t(out["lm_head"])
    return out


def quantizing_put_int4(inner_put, raw_put, group: int):
    """Wrap a loader ``put(tensor, name)`` hook so the seven layer matmuls
    are group-quantized where the loader holds them (the host) before
    placement: only packed bytes and scales reach the device. Every other
    leaf (embedding, lm_head, norms, biases) goes to ``inner_put``, which
    applies the int8 tier's formats to the embedding and lm_head."""
    group = int(group)

    def put(t: torch.Tensor, name: str):
        if name in INT4_LEAVES:
            leaf = quantize_group(t, group)
            return {"q4": raw_put(leaf["q4"]), "s": raw_put(leaf["s"])}
        return inner_put(t, name)

    return put


def is_int4(params: dict) -> bool:
    """True when the layer stack carries nibble-packed leaves."""
    layers = params.get("layers", {})
    for name in INT4_LEAVES:
        w = layers.get(name)
        if isinstance(w, dict) and "q4" in w:
            return True
    return False
