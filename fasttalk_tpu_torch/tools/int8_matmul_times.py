#!/usr/bin/env python3
"""Time one checkout's int8 decode matmuls on one CUDA GPU.

    python3 fasttalk_tpu_torch/tools/int8_matmul_times.py [--root DIR]
        [--out PATH]

Runs ``chip_smoke.py``'s phase-2 checks of ``int8_matmul`` and
``int8_matmul_t`` (every Llama-3.2-1B decode shape at M = 16 and M = 1,
held to the plain version, then timed by CUDA-graph replay beside the
plain version and the PyTorch library call) with the ``fasttalk_tpu_torch``
package imported from ``--root`` (default: the checkout holding this
file). The checks themselves always come from this checkout's
``chip_smoke.py``, so two checkouts are measured by the same code: run it
for each in turns (A, B, B, A) on one card. Prints one
JSON object (card, package path, per-shape figures and the step totals)
as its last line, and writes it to ``--out`` as well when given.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO,
                    help="checkout whose fasttalk_tpu_torch is timed")
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    import fasttalk_tpu_torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    results: dict = {}
    smoke.check_int8_matmul(results)
    smoke.check_int8_matmul_t(results)
    out = {"card": card, "package": os.path.dirname(fasttalk_tpu_torch.__file__),
           "results": results}
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
