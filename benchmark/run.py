"""The benchmark of quilt_tpu_torch on the H100 (see README.md):

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

prints one JSON line, the run's result, as the last line of its standard
output, and each number compared beside its limit as the last lines of
its standard error. It exits 2 without enough CUDA devices for the cell,
and 3 when a module of jax, jaxlib, flax or quilt_tpu was loaded."""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """The process's start on time.monotonic's clock (from its start time
    in /proc, in clock ticks since boot, against the uptime)."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.monotonic() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.monotonic()


T_START = _process_start()
ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the run at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchmark.harness import log, run_cell
    from benchmark.manifest import Manifest

    man = Manifest(ROOT)
    chips = int(man.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}")
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t_start=T_START, manifest=man)
    if result is None:
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
