"""Train the tinychat model on the synthetic chat corpus and export it as an
HF checkpoint: ``python -m fasttalk_tpu_torch train``.

The port's counterpart of ``scripts/train_tiny_chat.py``, with its model
(``TINYCHAT``), rows (``SEQ`` + 1 tokens, ``BATCH`` a step), tokenizer
recipe, schedule (linear warm-up to 1e-3, cosine to 1e-4) and AdamW weight
decay of 0.01, its held-out eval every 500 steps and its recall probe as
the gate of the export. The weights start from the port's random init
(``models/llama.py::init_params``, seeded by ``--seed``), so a run trains
other weights than the JAX script's from the same seed. The directory
written loads and serves through the standard path
(``MODEL_PATH=<parent of --out> LLM_MODEL=<its name>``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from fasttalk_tpu_torch.models.configs import ModelConfig
from fasttalk_tpu_torch.models.llama import init_params
from fasttalk_tpu_torch.parallel.sharding import shard_params
from fasttalk_tpu_torch.training.corpus import (CHAT_TEMPLATE_JINJA, SPECIALS,
                                                corpus_texts, render)
from fasttalk_tpu_torch.training.export import export_checkpoint
from fasttalk_tpu_torch.training.optim import (adamw,
                                               warmup_cosine_decay_schedule)
from fasttalk_tpu_torch.training.trainer import (greedy_generate,
                                                 make_eval_loss,
                                                 make_sampled_train_step,
                                                 pack_tokens,
                                                 single_device_mesh,
                                                 train_tokenizer)

TINYCHAT = ModelConfig(
    name="tinychat", vocab_size=2048, hidden_size=256,
    intermediate_size=768, num_layers=4, num_heads=8, num_kv_heads=4,
    head_dim=32, rope_theta=10000.0, rms_eps=1e-5, tie_embeddings=True,
    max_position=1024)

SEQ = 256
BATCH = 64
EVAL_EVERY = 500


def build_data(tok, n_convs: int, seed: int) -> np.ndarray:
    stream: list[int] = []
    for text in corpus_texts(n_convs, seed=seed):
        stream.extend(tok.encode(text, add_special_tokens=False).ids)
    return pack_tokens(stream, SEQ)


def recall_probe(params, tok, eot: int) -> tuple[int, int, list[str]]:
    """Greedy name/color recall over held-out conversations: the pass rate
    is the go/no-go for exporting."""
    probes = [
        ([{"role": "system",
           "content": "You are a helpful voice assistant. Keep "
                      "responses concise and conversational."},
          {"role": "user", "content": f"my name is {name}."},
          {"role": "assistant", "content": f"Nice to meet you, {name}!"},
          {"role": "user", "content": "what is my name?"}],
         name) for name in ("Alice", "Rex", "Marta", "Hugo")
    ] + [
        ([{"role": "user", "content": f"my favorite color is {c}."},
          {"role": "assistant", "content": f"{c.capitalize()} is a "
                                           "lovely color!"},
          {"role": "user", "content": "count from one to three."},
          {"role": "assistant", "content": "One, two, three."},
          {"role": "user", "content": "what is my favorite color?"}],
         c) for c in ("teal", "gold")
    ]
    ok, out = 0, []
    for msgs, expect in probes:
        ids = tok.encode(render(msgs, add_generation_prompt=True),
                         add_special_tokens=False).ids
        gen = greedy_generate(params, TINYCHAT, ids, max_new=24,
                              eos_id=eot)
        text = tok.decode(gen, skip_special_tokens=True)
        out.append(f"  {expect!r} -> {text!r}")
        if expect.lower() in text.lower():
            ok += 1
    return ok, len(probes), out


def add_arguments(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--convs", type=int, default=40000)
    ap.add_argument("--out", default=os.path.join("build", "tinychat"),
                    help="checkpoint directory to write (default: "
                    "build/tinychat)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--force-export", action="store_true",
                    help="export even if the recall probe fails "
                         "(smoke-testing the pipeline only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")


def train(args: argparse.Namespace) -> int:
    from fasttalk_tpu_torch.utils.config import resolve_device

    dev = resolve_device(args.device)
    print(f"device: {dev}", file=sys.stderr)
    os.makedirs(args.out, exist_ok=True)

    t0 = time.monotonic()
    texts = list(corpus_texts(args.convs, seed=args.seed))
    tok = train_tokenizer(texts, vocab_size=TINYCHAT.vocab_size,
                          specials=SPECIALS,
                          out_path=os.path.join(args.out, "tokenizer.json"))
    assert tok.get_vocab_size() <= TINYCHAT.vocab_size
    eot = tok.token_to_id("<|eot|>")
    data = build_data(tok, args.convs, args.seed)
    held = build_data(tok, 512, seed=args.seed + 1)[:BATCH]
    print(f"corpus: {args.convs} convs, {data.size:,} train tokens "
          f"({data.shape[0]} rows), vocab {tok.get_vocab_size()}, "
          f"{time.monotonic() - t0:.1f}s", file=sys.stderr)

    mesh = single_device_mesh()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = shard_params(init_params(TINYCHAT, gen, torch.float32, dev),
                          mesh)
    schedule = warmup_cosine_decay_schedule(
        0.0, 1e-3, warmup_steps=min(200, max(1, args.steps // 10)),
        decay_steps=args.steps, end_value=1e-4)
    optimizer = adamw(schedule, weight_decay=0.01)
    opt_state = optimizer.init(params)

    step_fn = make_sampled_train_step(TINYCHAT, optimizer, mesh, BATCH)
    eval_fn = make_eval_loss(TINYCHAT)
    data_dev = torch.as_tensor(data, device=dev).long()
    held_dev = torch.as_tensor(held, device=dev).long()

    t0 = time.monotonic()
    for step in range(args.steps):
        params, opt_state, loss = step_fn(params, opt_state, data_dev, step)
        if step % EVAL_EVERY == 0 or step == args.steps - 1:
            held_l = float(eval_fn(params, held_dev))
            print(f"step {step:5d}  train {float(loss):.4f}  "
                  f"held-out {held_l:.4f}  "
                  f"({time.monotonic() - t0:.0f}s)", file=sys.stderr)

    ok, total, lines = recall_probe(params, tok, eot)
    print(f"recall probe: {ok}/{total}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    if ok < total and not args.force_export:
        print("RECALL PROBE FAILED — not exporting. Train longer.",
              file=sys.stderr)
        return 1

    export_checkpoint(
        params, TINYCHAT, args.out,
        chat_template=CHAT_TEMPLATE_JINJA, eos_token="<|eot|>",
        bos_token="<|bos|>",
        tokenizer_json=os.path.join(args.out, "tokenizer.json"))
    print(f"exported {args.out}", file=sys.stderr)
    return 0
