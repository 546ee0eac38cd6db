"""Command line of the port.

``python -m fasttalk_tpu_torch websocket [--device cuda|cpu]`` runs the
launcher (serving/launcher.py): the engine from the environment
(utils/config.py: LLM_PROVIDER, LLM_MODEL, MODEL_PATH, TPU_DECODE_SLOTS,
TPU_MAX_MODEL_LEN, WEIGHT_QUANT, LLM_PORT, ...), the tool-calling agent
around it unless ENABLE_PYDANTIC_AI or ENABLE_TOOLS is false, warm-up
(TPU_WARMUP), the WebSocket protocol on ``/ws/llm``, the monitoring port
and the restart supervisor, until SIGINT or SIGTERM. A multi-rank port
runs one such process per device, each with TPU_COORDINATOR_ADDR,
TPU_NUM_PROCESSES, TPU_PROCESS_ID and the mesh sizes (TPU_TP_SIZE,
TPU_DP_SIZE, TPU_SP_SIZE): rank 0 with TPU_SPMD_ROLE=leader serves the
gateway, the others with TPU_SPMD_ROLE=follower replay its device calls
(parallel/spmd_serving.py).

``python -m fasttalk_tpu_torch quantize --model tinychat --model-path
fasttalk_tpu/assets [--group 128] [--calib corpus|FILE] [--calib-samples 16]
[--seq-len 256] [--dtype bfloat16] [--data-free] [--seed 0] [--device
cuda|cpu]`` quantizes a float checkpoint to the int4 tier, AWQ-calibrated
unless ``--data-free`` (on ``--calib``, else the WEIGHT_QUANT_CALIB
setting, else the tinychat corpus), and writes it into the prepared-weight
cache (``<MODEL_PATH>/.prepared_torch/``) with ``quantize_manifest.json``
beside it; a server started afterwards with WEIGHT_QUANT=int4 and the same
group and dtype restores it. The counterpart of
``scripts/quantize_checkpoint.py``.
"""

from __future__ import annotations

import argparse
import sys


def quantize(args: argparse.Namespace) -> int:
    import torch

    from fasttalk_tpu_torch.engine.tokenizer import load_tokenizer
    from fasttalk_tpu_torch.models.configs import get_model_config
    from fasttalk_tpu_torch.models.loader import (find_checkpoint_dir,
                                                  load_params)
    from fasttalk_tpu_torch.models.prepared_cache import (cache_meta,
                                                          save_prepared)
    from fasttalk_tpu_torch.quantization.int4 import (quantize_params_int4,
                                                      validate_group)
    from fasttalk_tpu_torch.utils.config import resolve_device

    dev = resolve_device(args.device)
    model_cfg = get_model_config(args.model, args.model_path)
    validate_group(model_cfg, args.group)
    ckpt = find_checkpoint_dir(args.model_path, model_cfg.name)
    if not ckpt:
        print(f"error: no checkpoint for {model_cfg.name!r} under "
              f"{args.model_path!r}", file=sys.stderr)
        return 2
    dtype = getattr(torch, args.dtype)
    # Float32 load: the scale search wants full-precision statistics.
    params = load_params(model_cfg, ckpt, torch.float32, dev)
    manifest: dict = {"mode": "data-free", "group": int(args.group),
                      "model": model_cfg.name}
    if args.data_free:
        qparams = quantize_params_int4(params, args.group)
    else:
        from fasttalk_tpu_torch.quantization.awq import (calibration_tokens,
                                                         quantize_params_awq)
        from fasttalk_tpu_torch.utils.config import Config

        calib = args.calib or Config().weight_quant_calib or "corpus"
        tokenizer = load_tokenizer(args.model_path, args.model,
                                   template=model_cfg.chat_template)
        tokens = calibration_tokens(
            tokenizer, n_samples=args.calib_samples, seq_len=args.seq_len,
            seed=args.seed, source=calib)
        print(f"calibrating on {tokens.shape[0]} x {tokens.shape[1]} "
              f"tokens from {calib!r}")
        qparams, awq_info = quantize_params_awq(params, model_cfg, tokens,
                                                args.group)
        manifest = {"mode": "awq", "model": model_cfg.name,
                    "calib": calib,
                    "calib_samples": int(tokens.shape[0]),
                    "seq_len": int(tokens.shape[1]),
                    "seed": args.seed, **awq_info}

    # Plain leaves (norms, biases) in the serving dtype, as the factory's
    # load path gives them; scales stay float32 by format.
    def cast_plain(tree: dict) -> dict:
        return {k: cast_plain(v) if isinstance(v, dict)
                else (v.to(dtype) if k != "s" and v.dtype == torch.float32
                      else v) for k, v in tree.items()}

    meta = cache_meta(model_cfg, dtype, "int4", ckpt, group=args.group)
    path = save_prepared(cast_plain(qparams), args.model_path, meta,
                         extra={"quantize_manifest.json": manifest},
                         block=True)
    if path is None:
        print("error: prepared-cache write failed", file=sys.stderr)
        return 1
    print(f"int4 prepared cache written: {path}")
    print(f"serve with: WEIGHT_QUANT=int4 WEIGHT_QUANT_GROUP={args.group} "
          f"TPU_DTYPE={args.dtype} LLM_MODEL={args.model} "
          f"MODEL_PATH={args.model_path} python -m fasttalk_tpu_torch "
          "websocket")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m fasttalk_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    ws = sub.add_parser("websocket", help="serve the WebSocket protocol")
    ws.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda; a rank "
                    "of a mesh takes its own card)")
    qz = sub.add_parser("quantize", help="quantize a checkpoint to int4 "
                        "(AWQ-calibrated by default) into the prepared cache")
    qz.add_argument("--model", default="tinychat",
                    help="model config name (models/configs.py)")
    qz.add_argument("--model-path", default="fasttalk_tpu/assets",
                    help="MODEL_PATH the server will use")
    qz.add_argument("--group", type=int, default=128,
                    help="WEIGHT_QUANT_GROUP the server will use")
    qz.add_argument("--calib", default=None,
                    help="'corpus' or a UTF-8 text file of documents "
                    "(default: WEIGHT_QUANT_CALIB, else 'corpus')")
    qz.add_argument("--calib-samples", type=int, default=16)
    qz.add_argument("--seq-len", type=int, default=256)
    qz.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32", "float16"),
                    help="serving dtype the cache is keyed by")
    qz.add_argument("--data-free", action="store_true",
                    help="skip AWQ; plain group-wise maxabs scales")
    qz.add_argument("--seed", type=int, default=0)
    qz.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)
    if args.command == "quantize":
        return quantize(args)

    from fasttalk_tpu_torch.serving.launcher import (ServerLauncher,
                                                     run_spmd_follower)
    from fasttalk_tpu_torch.utils.config import Config

    config = Config()
    if config.spmd_role == "follower":
        return run_spmd_follower(config, device=args.device)
    ServerLauncher(config, device=args.device).start()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
