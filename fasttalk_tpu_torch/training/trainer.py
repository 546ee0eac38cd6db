"""The training loop's pieces on top of the sharded train step.

Counterpart of ``fasttalk_tpu/training/trainer.py``. The packed dataset
stays on the device, and each step draws its batch rows there
(``sample_rows``: ``torch.randint`` from a generator on the data's device
seeded from (17, step), where JAX folds the step into ``PRNGKey(17)``; the
two draw different rows, so they are held to each other by distribution).
Every rank of a mesh draws the same rows and takes its part of them.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

from fasttalk_tpu_torch.models.configs import ModelConfig
from fasttalk_tpu_torch.models.llama import forward
from fasttalk_tpu_torch.parallel.mesh import Mesh, MeshSpec
from fasttalk_tpu_torch.parallel.train import causal_lm_loss, make_train_step

# Prompt lengths round up to a multiple of this in ``greedy_generate``.
_BUCKET = 64


def pack_tokens(token_stream: list[int], seq_len: int) -> np.ndarray:
    """Pack a flat token stream into [N, seq_len + 1] rows (the +1
    feeds next-token targets). The tail remainder is dropped."""
    row = seq_len + 1
    n = len(token_stream) // row
    return np.asarray(token_stream[:n * row], np.int32).reshape(n, row)


def sample_rows(n_rows: int, batch: int, step: int,
                device: torch.device | str) -> torch.Tensor:
    """The ``batch`` row indices (with replacement) that step ``step``
    draws from a dataset of ``n_rows``, on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed((17 << 32) + int(step))
    return torch.randint(0, n_rows, (batch,), generator=gen, device=device)


def make_sampled_train_step(cfg: ModelConfig, optimizer: Any,
                            mesh: Mesh | None, batch: int) -> Callable:
    """``(params, opt_state, data, step) -> (params, opt_state, loss)``
    where ``data`` is the device-resident packed dataset [N, T + 1] and the
    batch is the rows ``sample_rows`` draws for ``step`` (sampling with
    replacement, fine for a many-epoch tiny run). On "sp" the attention is
    the gathered form, as JAX's GSPMD lowers it."""
    train = make_train_step(cfg, optimizer, mesh, ring_min_seq=math.inf)

    def train_step(params, opt_state, data, step):
        idx = sample_rows(data.shape[0], batch, step, data.device)
        return train(params, opt_state, data[idx])

    return train_step


def make_eval_loss(cfg: ModelConfig) -> Callable:
    """Mean next-token loss over a fixed [B, T + 1] batch."""

    def step(params, tokens):
        tokens = torch.as_tensor(
            tokens, device=params["final_norm"].device).long()
        with torch.no_grad():
            return causal_lm_loss(params, cfg, tokens)

    return step


def greedy_generate(params: Any, cfg: ModelConfig, prompt_ids: list[int],
                    max_new: int = 48, eos_id: int | None = None,
                    ) -> list[int]:
    """Host-driven greedy decode for in-training eval: one full-prompt
    forward per token over the prompt padded to a multiple of 64 tokens
    (causal attention hides the padding), as JAX's buckets keep its jit
    cache small; slow but free of the engine. Serving uses the engine."""
    device = params["final_norm"].device
    ids = list(prompt_ids)
    with torch.inference_mode():
        for _ in range(max_new):
            t = len(ids)
            bucket = -(-t // _BUCKET) * _BUCKET
            padded = torch.zeros((1, bucket), dtype=torch.long,
                                 device=device)
            padded[0, :t] = torch.as_tensor(ids)
            logits, _ = forward(params, cfg, padded,
                                torch.arange(bucket, device=device)[None],
                                None, None,
                                logits_indices=torch.tensor([t - 1],
                                                            device=device))
            nxt = int(torch.argmax(logits[0, -1]))
            ids.append(nxt)
            if eos_id is not None and nxt == eos_id:
                break
    return ids[len(prompt_ids):]


def single_device_mesh() -> Mesh:
    """A ("dp", "sp", "tp") mesh of one rank: the degenerate shape that
    lets the sharded train step run anywhere."""
    return Mesh(MeshSpec(), 0)


def train_tokenizer(texts: list[str], vocab_size: int, specials: list[str],
                    out_path: str) -> Any:
    """Train a ByteLevel BPE on the corpus (same recipe as
    scripts/make_bench_tokenizer.py) with the chat specials."""
    from tokenizers import Tokenizer, decoders, pre_tokenizers, processors
    from tokenizers.models import BPE
    from tokenizers.trainers import BpeTrainer

    tok = Tokenizer(BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    trainer = BpeTrainer(vocab_size=vocab_size, special_tokens=specials,
                         show_progress=False)
    tok.train_from_iterator(texts, trainer)
    tok.save(out_path)
    return tok
