"""Prepared-weight cache: the engine-ready parameter dict on disk.

Counterpart of ``fasttalk_tpu/models/prepared_cache.py``. The slow part of
starting from a checkpoint is the transform (safetensors -> transpose ->
stack layers -> cast -> quantize); this module stores its result so a
restart reads the final tensors straight back. The JAX package stores with
Orbax; the port flattens the dict (``layers/wq/q4`` keys) into one
``params.safetensors`` with ``fasttalk_meta.json`` beside it, under a
directory of its own, ``<MODEL_PATH>/.prepared_torch/<tag>/``, so it never
collides with the JAX package's ``.prepared/``.

Cache key: model name, serving dtype, weight tier (and the int4 group),
the source checkpoint's files (name, size, mtime) and a digest of the
loading and quantization code (``transform_version``). Any mismatch
ignores the cache; the factory writes a fresh one after its slow load.
``python -m fasttalk_tpu_torch quantize`` writes AWQ-calibrated int4
weights into the same place, where the factory finds them first.

A cache is written into a temporary directory (tensors first, the meta
file last) and moved into place with ``os.replace``, so a reader never sees
a partial cache and two writers of one checkpoint never mix their files.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import shutil
import tempfile
from typing import Any

import torch

from fasttalk_tpu_torch.models.configs import ModelConfig
from fasttalk_tpu_torch.models.loader import weight_tier
from fasttalk_tpu_torch.utils.logger import get_logger

log = get_logger("models.prepared_cache")

_META = "fasttalk_meta.json"
_TENSORS = "params.safetensors"
# Modules of the package whose code decides the cached tensors' values.
_TRANSFORM_SOURCES = ("models/loader.py", "ops/quant.py",
                      "quantization/int4.py", "quantization/awq.py")


def checkpoint_fingerprint(ckpt_dir: str | None) -> list | None:
    """Identity of the source checkpoint files (name, size, mtime): an
    updated checkpoint invalidates the prepared cache."""
    if not ckpt_dir or not os.path.isdir(ckpt_dir):
        return None
    out = []
    for f in sorted(os.listdir(ckpt_dir)):
        if f.endswith((".safetensors", ".json")):
            st = os.stat(os.path.join(ckpt_dir, f))
            out.append([f, st.st_size, int(st.st_mtime)])
    return out


@functools.lru_cache(maxsize=1)
def transform_version() -> str:
    """Digest of the sources that turn a checkpoint into the cached
    tensors: a change to the loading or quantization code invalidates every
    cache written before it."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.sha256()
    for rel in _TRANSFORM_SOURCES:
        with open(os.path.join(pkg, rel), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def cache_meta(cfg: ModelConfig, dtype: torch.dtype, quantize: bool | str,
               ckpt_dir: str | None = None, group: int = 128) -> dict:
    tier = weight_tier(quantize)
    meta = {
        "format": 1,
        "code": transform_version(),
        "model": cfg.name,
        "dtype": str(dtype).replace("torch.", ""),
        "quantize": tier,
        "source": checkpoint_fingerprint(ckpt_dir),
    }
    if tier == "int4":
        # The group changes the scale shapes; only int4 metas carry it.
        meta["group"] = int(group)
    return meta


def cache_dir(model_path: str, meta: dict) -> str:
    quant = meta["quantize"]
    if meta.get("group"):
        quant = f"{quant}-g{meta['group']}"
    tag = "-".join([meta["model"].replace(":", "_").replace("/", "_"),
                    meta["dtype"], quant])
    return os.path.join(model_path, ".prepared_torch", tag)


def _flatten(tree: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    if isinstance(tree, dict):
        out: dict[str, torch.Tensor] = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree.detach().to("cpu").contiguous()}


def _unflatten(flat: dict[str, torch.Tensor]) -> dict:
    out: dict = {}
    for key, t in flat.items():
        node = out
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return out


def save_prepared(params: dict, model_path: str, meta: dict,
                  extra: dict[str, Any] | None = None) -> str | None:
    """Write the engine-ready dict (and ``extra`` JSON files, name ->
    object, beside it); best-effort: serving works without the cache.
    Returns the cache directory, or None when nothing was written."""
    from safetensors.torch import save_file

    path = cache_dir(model_path, meta)
    parent = os.path.dirname(path)
    try:
        os.makedirs(parent, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=".tmp-", dir=parent)
    except OSError as e:
        log.warning(f"prepared cache dir not writable: {path} ({e})")
        return None
    try:
        save_file(_flatten(params), os.path.join(tmp, _TENSORS))
        for name, obj in (extra or {}).items():
            with open(os.path.join(tmp, name), "w", encoding="utf-8") as f:
                json.dump(obj, f, indent=2)
        with open(os.path.join(tmp, _META), "w", encoding="utf-8") as f:
            json.dump(meta, f)
        if os.path.isdir(path):
            # Move the old cache aside first: os.replace cannot replace a
            # non-empty directory.
            old = tempfile.mkdtemp(prefix=".old-", dir=parent)
            os.replace(path, os.path.join(old, "cache"))
            shutil.rmtree(old, ignore_errors=True)
        os.replace(tmp, path)
        log.info(f"prepared-weight cache written: {path}")
        return path
    except OSError as e:
        # Another writer put its cache in place between our steps; theirs
        # holds the same weights.
        log.warning(f"prepared cache save skipped ({e})")
        return path if os.path.isfile(os.path.join(path, _META)) else None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load_prepared(cfg: ModelConfig, model_path: str, dtype: torch.dtype,
                  quantize: bool | str, ckpt_dir: str | None = None,
                  group: int = 128,
                  device: torch.device | str = "cuda") -> dict | None:
    """The engine-ready dict on ``device``, or None when the cache is
    absent, mismatched or unreadable."""
    from safetensors.torch import load_file

    meta = cache_meta(cfg, dtype, quantize, ckpt_dir, group=group)
    path = cache_dir(model_path, meta)
    meta_file = os.path.join(path, _META)
    if not os.path.isfile(meta_file):
        return None
    try:
        with open(meta_file, encoding="utf-8") as f:
            have = json.load(f)
        if have != meta:
            log.warning(f"prepared cache mismatch at {path}; ignoring")
            return None
        params = _unflatten(load_file(os.path.join(path, _TENSORS),
                                      device=str(device)))
        log.info(f"restored prepared weights from {path}")
        return params
    except Exception as e:  # a torn or foreign cache: reload instead
        log.warning(f"prepared cache restore failed (reloading): {e}")
        return None
