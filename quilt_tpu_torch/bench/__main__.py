"""python -m quilt_tpu_torch.bench {fb,gibbs,full} [--samples N] [--out DIR]

fb prints bench.py's one JSON line; gibbs and full write
bench_torch_gibbs.json / bench_torch_full.json into --out and print them.
Every program runs on the card and exits non-zero without one."""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from . import fb, full, gibbs
from .common import require_cuda
from .full import N_SAMPLES

OUTPUTS = {"gibbs": "bench_torch_gibbs.json", "full": "bench_torch_full.json"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m quilt_tpu_torch.bench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("program", choices=("fb", "gibbs", "full"))
    ap.add_argument("--samples", type=int, default=N_SAMPLES,
                    help="samples of the end-to-end sections of `full` (default %(default)s)")
    ap.add_argument("--out", default=".", help="directory of the JSON reports")
    args = ap.parse_args(argv)
    if args.samples < 2:
        ap.error("--samples must be at least 2 (the batched engine)")
    try:
        device = require_cuda("cuda")
    except RuntimeError as e:
        print(f"quilt_tpu_torch.bench: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.program == "fb":
        fb.main(device)
        return 0
    if args.program == "gibbs":
        report = gibbs.main(device)
    else:
        report = full.full_report(device, args.samples)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, OUTPUTS[args.program])
    with open(path, "w") as fh:
        json.dump(report, fh, indent=2)
    print(json.dumps(report, indent=2), flush=True)
    print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
