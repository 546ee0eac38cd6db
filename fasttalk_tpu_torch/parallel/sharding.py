"""Sharding rules for the Llama parameter dict and the KV cache.

Counterpart of ``fasttalk_tpu/parallel/sharding.py``: the same rules, by
leaf name (a spec is a tuple naming the mesh axis of each array axis, or
None), and the same checks with the same messages. Where the JAX package
hands a spec to GSPMD, the port cuts the leaf to this rank's local shard,
the slice ``jax.Array.addressable_shards`` holds at the same mesh
coordinates:

- wq/wk/wv and w_gate/w_up are column-parallel (output axis over "tp"):
  each rank computes its own heads and FFN slice with no communication;
- wo and w_down are row-parallel (contraction axis over "tp"): their
  partial outputs are summed over "tp" (parallel/collectives.py);
- the embedding shards its hidden axis, so the tied head is row-parallel
  too (partial logits, then a sum); an untied lm_head is column-parallel
  over the vocabulary;
- the KV cache [L, slots, S, kv_heads, head_dim] shards slots over "dp",
  the sequence over "sp" and KV heads over "tp".

Norm scales and the rope tables stay replicated.
"""

from __future__ import annotations

from typing import Any

import torch

from fasttalk_tpu_torch.parallel.mesh import Mesh

Spec = tuple

# Specs include the leading stacked layer axis for everything in "layers".
_LAYER_RULES: dict[str, Spec] = {
    "attn_norm": (None, None),
    "mlp_norm": (None, None),
    "wq": (None, None, "tp"),
    "wk": (None, None, "tp"),
    "wv": (None, None, "tp"),
    # Column-parallel biases shard with their matmul's output axis.
    "bq": (None, "tp"),
    "bk": (None, "tp"),
    "bv": (None, "tp"),
    "wo": (None, "tp", None),
    "w_gate": (None, None, "tp"),
    "w_up": (None, None, "tp"),
    "w_down": (None, "tp", None),
}
_TOP_RULES: dict[str, Spec] = {
    "embed": (None, "tp"),
    "final_norm": (None,),
    "lm_head": (None, "tp"),
}


def _spec_for(name: str, ndim: int, shape=None, parent: str = "") -> Spec:
    """The spec of a parameter leaf (unknown: replicated).

    Int8 leaves ``{"q", "s"}``: "q" shards like the weight, the
    per-output-channel scale "s" like the weight's last axis; the
    embedding's per-row scale [V] is replicated. Int4 leaves ``{"q4",
    "s"}``: the nibble packing pairs adjacent contraction rows, so "q4"
    keeps the weight's own spec, and the group scale [..., K/G, N] keeps
    the weight's leading axes, its group axis placed like the contraction
    axis. ``"qt"`` (the transposed untied head [V, D]) leads with the
    vocabulary axis."""
    if name in ("q", "qt", "q4", "s") and parent:
        base = _TOP_RULES.get(parent) or _LAYER_RULES.get(parent)
        if base is not None:
            if name == "qt":
                spec = (base[-1], *base[:-1])
            elif name in ("q", "q4"):
                spec = base
            elif parent == "embed":
                spec = (None,)
            else:
                spec = (*base[:ndim - 1], base[-1])
            if len(spec) != ndim:
                raise ValueError(
                    f"spec {spec} rank mismatch for {parent}/{name} "
                    f"with shape {shape}")
            return spec
    spec = _TOP_RULES.get(name) or _LAYER_RULES.get(name)
    if spec is None:
        return (None,) * ndim
    if len(spec) != ndim:
        raise ValueError(
            f"spec {spec} rank mismatch for {name} with shape {shape}")
    return spec


def local_slices(spec: Spec, shape: tuple, mesh: Mesh) -> tuple:
    """The index of this rank's shard of an array of ``shape`` laid out by
    ``spec`` (each named axis split evenly over its mesh axis)."""
    out = []
    for dim, axis in zip(shape, spec):
        if axis is None or mesh.shape[axis] == 1:
            out.append(slice(None))
            continue
        n = mesh.shape[axis]
        if dim % n:
            raise ValueError(f"{axis}={n} does not divide an axis of "
                             f"size {dim}")
        w = dim // n
        i = mesh.coords[axis]
        out.append(slice(i * w, (i + 1) * w))
    return tuple(out)


def cut(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of ``t`` as a tensor of its own (no view of the
    full array is kept alive)."""
    idx = local_slices(spec, tuple(t.shape), mesh)
    if all(s == slice(None) for s in idx):
        return t
    return t[idx].contiguous().clone()


def shard_leaf(t: torch.Tensor, name: str, parent: str,
               mesh: Mesh, stacked: bool = True) -> torch.Tensor:
    """One leaf (``stacked=False``: one layer's slice of a stacked leaf)
    cut to this rank's shard."""
    ndim = t.dim() + (0 if stacked else 1)
    spec = _spec_for(name, ndim, tuple(t.shape), parent=parent)
    return cut(t, spec if stacked else spec[1:], mesh)


def shard_named(value: Any, name: str, mesh: Mesh | None,
                stacked: bool = True) -> Any:
    """A top or layer leaf by name (a tensor, or an int8/int4 leaf dict)
    cut to this rank's shard; as it is without a mesh."""
    if mesh is None:
        return value
    if isinstance(value, dict):
        return {k: shard_leaf(v, k, name, mesh, stacked)
                for k, v in value.items()}
    return shard_leaf(value, name, "", mesh, stacked)


def shard_params(params: Any, mesh: Mesh, parent: str = "") -> Any:
    """The parameter dict cut to this rank's shards."""
    return {k: shard_params(v, mesh, k) if isinstance(v, dict)
            else shard_leaf(v, k, parent, mesh)
            for k, v in params.items()}


def cache_pspecs() -> Spec:
    """Cache layout [L, slots, S, kv_heads, head_dim]: slots over "dp",
    sequence over "sp", KV heads over "tp" (one spec for k and v)."""
    return (None, "dp", "sp", "tp", None)


def cache_local_shape(num_layers: int, slots: int, max_len: int,
                      kv_heads: int, head_dim: int,
                      mesh: Mesh) -> tuple[int, ...]:
    """The shape of this rank's shard of the cache."""
    full = (num_layers, slots, max_len, kv_heads, head_dim)
    idx = local_slices(cache_pspecs(), full, mesh)
    return tuple(len(range(*s.indices(d))) for s, d in zip(idx, full))


def validate_tp(tp: int, num_kv_heads: int, num_heads: int,
                hidden: int, intermediate: int,
                vocab: int | None = None) -> None:
    """Fail fast on meshes the model cannot shard evenly."""
    dims = [(num_kv_heads, "num_kv_heads"), (num_heads, "num_heads"),
            (hidden, "hidden_size"), (intermediate, "intermediate_size")]
    if vocab is not None:
        dims.append((vocab, "vocab_size"))  # lm_head is vocab-sharded
    for dim, label in dims:
        if dim % tp:
            raise ValueError(f"tp={tp} does not divide {label}={dim}")


def validate_int4_tp(tp: int, *, q_dim: int, intermediate: int,
                     group: int) -> None:
    """The divisibility the int4 leaves add to ``validate_tp``: tp must
    divide the packed row count (a shard boundary must never split a
    nibble pair) and the group count (nor split a scale group) of the
    row-parallel wo and w_down."""
    for dim, label in ((q_dim, "q_dim (wo)"),
                       (intermediate, "intermediate_size (w_down)")):
        if (dim // 2) % tp:
            raise ValueError(
                f"tp={tp} does not divide the packed int4 row count "
                f"{label.split(' ')[0]}/2={dim // 2} for {label}; a shard "
                f"boundary would split a nibble pair")
        if (dim // group) % tp:
            raise ValueError(
                f"tp={tp} does not divide the int4 scale-group count "
                f"{dim}//{group}={dim // group} for {label}; a shard "
                f"boundary would split a scale group")


def validate_mesh(mesh: Mesh, *, num_kv_heads: int, num_heads: int,
                  hidden: int, intermediate: int, vocab: int,
                  num_slots: int, max_len: int) -> None:
    """Every mesh axis against the tensors it shards, so a bad
    TPU_TP_SIZE/TPU_DP_SIZE/TPU_SP_SIZE fails with a named message at
    engine build."""
    validate_tp(mesh.shape.get("tp", 1), num_kv_heads, num_heads, hidden,
                intermediate, vocab)
    dp = mesh.shape.get("dp", 1)
    if num_slots % dp:
        raise ValueError(
            f"dp={dp} does not divide decode_slots={num_slots}")
    sp = mesh.shape.get("sp", 1)
    if max_len % sp:
        raise ValueError(f"sp={sp} does not divide max_model_len={max_len}")
