#!/usr/bin/env python3
"""Time the port's kernels on one CUDA GPU, for one checkout or several in
turns.

    python3 fasttalk_tpu_torch/tools/kernel_times.py [--checks A,B,...]
        [--root DIR | --roots DIR,DIR,...]
        [--lengths ragged|uniform|N,N,...] [--out PATH]

Runs ``chip_smoke.py``'s phase-2 checks named by ``--checks`` (default:
all of them): ``int8_matmul``, ``int8_matmul_t``, ``int4_matmul``,
``decode_attend``, ``decode_attend[int8]``, ``decode_attend_paged``,
``decode_attend_paged[int8]``. Each holds the kernel to its plain version
at the Llama-3.2-1B decode shapes and times it by CUDA-graph replay
beside the plain version, the PyTorch library call and its bound. The
``fasttalk_tpu_torch`` package is imported from ``--root`` (default: the
checkout holding this file); the checks always come from this checkout's
``chip_smoke.py``, so every checkout is measured by the same code.
``--lengths uniform`` gives the attention checks' 16 slots the same key
total as ``chip_smoke.ATTEND_LENGTHS`` (``ragged``, the default) spread
evenly, so the two tell the cost of the spread of lengths apart from the
cost of the keys; a list of 16 lengths (each at most 2048) sets them
outright, so a few lists tell the cost of a key from the cost of a
call.
``--roots`` runs one process per entry, in the order given (parent,
change, change, parent compares two checkouts on one card), and collects
their results. Prints one JSON object as its last line (card, and per
turn the package path and the results), and writes it to ``--out`` as
well when given.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ATTENTION = {"decode_attend": (False, False),
             "decode_attend[int8]": (False, True),
             "decode_attend_paged": (True, False),
             "decode_attend_paged[int8]": (True, True)}
CHECKS = ("int8_matmul", "int8_matmul_t", "int4_matmul", *ATTENTION)


def card_name() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"


def uniform_lengths(ragged: list[int]) -> list[int]:
    """``ragged``'s key total spread as evenly as it goes over as many
    slots."""
    base, extra = divmod(sum(ragged), len(ragged))
    return [base + (i < extra) for i in range(len(ragged))]


def run_checks(root: str, checks: list[str], lengths: str) -> dict:
    """Import the package from ``root`` and run the named checks."""
    import torch

    sys.path.insert(0, os.path.abspath(root))
    import fasttalk_tpu_torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if lengths == "uniform":
        smoke.ATTEND_LENGTHS = uniform_lengths(smoke.ATTEND_LENGTHS)
    elif lengths != "ragged":
        smoke.ATTEND_LENGTHS = [int(n) for n in lengths.split(",")]
        if len(smoke.ATTEND_LENGTHS) != smoke.SLOTS or not all(
                1 <= n <= smoke.MAX_LEN for n in smoke.ATTEND_LENGTHS):
            raise SystemExit(f"--lengths: {smoke.SLOTS} lengths in "
                             f"[1, {smoke.MAX_LEN}], got {lengths}")
    torch.backends.cuda.matmul.allow_tf32 = False
    results: dict = {}
    for name in checks:
        if name in ATTENTION:
            paged, int8 = ATTENTION[name]
            smoke.check_attend(results, name, paged=paged, int8=int8,
                               seed=3 + list(ATTENTION).index(name))
            torch.cuda.empty_cache()
        else:
            getattr(smoke, f"check_{name}")(results)
    return {"package": os.path.dirname(fasttalk_tpu_torch.__file__),
            "lengths": smoke.ATTEND_LENGTHS, "results": results}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checks", default=",".join(CHECKS),
                    help="comma-separated phase-2 checks to run")
    ap.add_argument("--root", default=REPO,
                    help="checkout whose fasttalk_tpu_torch is timed")
    ap.add_argument("--roots", default="",
                    help="checkouts to time in turns, one process each")
    ap.add_argument("--lengths", default="ragged",
                    help="attention slot lengths: 'ragged' (chip_smoke's), "
                         "'uniform' (the same key total spread evenly) or "
                         "16 comma-separated lengths")
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    checks = [c for c in args.checks.split(",") if c]
    unknown = sorted(set(checks) - set(CHECKS))
    if unknown:
        print(f"unknown checks {unknown}; choose from {CHECKS}",
              file=sys.stderr)
        return 2
    if args.roots:
        turns = []
        for root in args.roots.split(","):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--checks",
                 ",".join(checks), "--root", root, "--lengths",
                 args.lengths], capture_output=True,
                text=True)
            sys.stderr.write(proc.stderr[-4000:])
            if proc.returncode != 0:
                print(proc.stdout[-4000:], file=sys.stderr)
                return proc.returncode
            turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        out = {"card": card_name(), "turns": turns}
    else:
        out = {"card": card_name(),
               **run_checks(args.root, checks, args.lengths)}
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
