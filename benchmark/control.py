"""The control of the comparison that decides `correct`, with the
program's own readings beside it, on several seeds in one process:

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 [--seconds 0]
        [--witness] [--fault beta_ones]

For each seed it runs the cell as run.py does, with a window of
`--seconds` (0: one batch after the warm-up, the cell's own load), and
prints one JSON line: the program's numbers (sweep_alpha_gap,
wrong_draw_share, dosage_gap, and the draws judged), and the control's:
the reference computed in bfloat16 put in the program's place, on the
same state (its forward probabilities, its draws: the labels its own
P(label 0) gives with the program's uniforms, judged against the float64
reference's; its dosages). With `--fault`, the program runs with that
fault planted and the line holds its numbers alone. The benchmark's own
runs never run this. The limits in the configurations' files were set
from these readings (PERF.md).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def sweep_against_reference(keep, dtype, device) -> dict:
    """The kept sweeps worked by the reference in `dtype`, put in the
    program's place: its forward probabilities' gap to the float64
    reference's (median over rows, as check.py takes it, and largest), and
    its own draws judged against the float64 reference's P(label 0)."""
    import numpy as np

    from benchmark import check
    from benchmark.reference import hmm

    cmp = keep["compare"]
    imp = keep["config"]["impute"]
    low = check.sweep_numbers(keep["state"], cmp["tables"], keep["world"].rhb, cmp["stay"],
                              cmp["jump"], float(imp.get("maxDifferenceBetweenReads", 1e10)),
                              dtype=dtype, device=device)
    gap, rows, wrong, judged = 0.0, [], 0, 0
    for key, (p_low, lab_in, _, u, a_low) in low["p"].items():
        p_ref, a_ref = cmp["sweep"]["p"][key][0], cmp["sweep"]["p"][key][4]
        for pl, li, uu, pr in zip(p_low, lab_in, u, p_ref):
            g = hmm.decision_gaps(hmm.control_draws(pl, uu, li), li, uu, pr)
            gap, wrong = max(gap, float(g.max(initial=0.0))), wrong + int((g > 0).sum())
            judged += int(np.isfinite(pr).sum())
        rows.extend(check.row_gaps(a_low, a_ref))
    return {"sweep_alpha_gap": float(np.median(rows)), "alpha_max": float(max(rows)),
            "draw_gap": gap, "draws_wrong": wrong, "wrong_draw_share": wrong / max(judged, 1),
            "low": low}


def control_numbers(keep, device) -> dict:
    """The control's numbers on the state a run kept (harness.run_cell's
    `keep`): the reference in bfloat16 in the program's place."""
    import numpy as np
    import torch

    from benchmark import check
    from benchmark.reference import hmm

    cmp = keep["compare"]
    config = keep["config"]
    out = sweep_against_reference(keep, torch.bfloat16, device)
    out.pop("low")
    d_low = check.reference_dosages(keep["state"], cmp["tables"],
                                    hmm.panel_words_T(keep["world"].rhb, device), cmp["stay"],
                                    cmp["jump"], config["impute"], float(config["ref_error"]),
                                    int(config["nSNPs"]), dtype=torch.bfloat16)
    out["dosage_gap"] = float(np.abs(d_low - cmp["ref"]).max())
    return out


def float32_witness(keep, device) -> dict:
    """The reference's sweeps in float32, the configuration's precision:
    its gap to the float64 reference, and the program's gap to it (row by
    row: where the program leaves the float64 reference, does float32 arithmetic
    leave it too)."""
    import numpy as np
    import torch

    from benchmark import check

    w = sweep_against_reference(keep, torch.float32, device)
    st = keep["state"]
    prog_vs_32 = []
    for (call, it), (_, _, _, _, a32) in w["low"]["p"].items():
        rec = st["sweeps"][(call, it)]
        prog_a = np.stack([a[..., :rec["K_real"]] for a in rec["alphas"]], 1)
        prog_vs_32.extend(check.row_gaps(prog_a, a32))
    return {"f32_vs_f64_alpha_max": w["alpha_max"], "f32_draws_wrong": w["draws_wrong"],
            "f32_draw_gap": w["draw_gap"], "program_vs_f32_alpha_max": float(max(prog_vs_32)),
            "program_vs_f32_alpha_median": float(np.median(prog_vs_32))}


def plant(fault: str):
    """Break the timed path underneath for a fault's reading; returns the
    undo. `beta_ones`: the Gibbs backward sweep returns its state
    unchanged, the backward probabilities at their initial ones."""
    if fault == "none":
        return lambda: None
    import torch

    import quilt_tpu_torch.kernels.gibbs as gibbs_mod

    real = gibbs_mod.bwd_sweep
    if fault == "beta_ones":
        gibbs_mod.bwd_sweep = lambda *a, **kw: torch.ones_like(real(*a, **kw))
    else:
        raise ValueError(f"no fault named {fault!r}")

    def undo():
        gibbs_mod.bwd_sweep = real
    return undo


def main(argv=None) -> int:
    import argparse

    import torch

    from benchmark.harness import log, run_cell
    from benchmark.manifest import Manifest

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--witness", action="store_true",
                    help="also the reference's sweeps in float32, beside the program's")
    ap.add_argument("--fault", default="none", choices=("none", "beta_ones"),
                    help="read the program's numbers with this fault planted")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("the control runs on the card")
        return 2
    man = Manifest(ROOT)
    undo = plant(args.fault)
    for seed in args.seeds:
        keep = {}
        res = run_cell(ROOT, args.workload, seed, args.seconds, False, manifest=man, keep=keep)
        ctrl = control_numbers(keep, "cuda") if args.fault == "none" else None
        wit = float32_witness(keep, "cuda") if args.witness else None
        sw = keep["compare"]["sweep"]
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "program": {k: v["value"] for k, v in res["checks"].items()},
                          "program_draw_gap": sw["gap"], "program_draws_wrong": sw["wrong"],
                          "program_alpha_max": sw["alpha_max"], "draws": sw["reads"],
                          "correct": res["correct"],
                          "float32_witness": wit,
                          "control": ctrl, "kind": res["device"]["kind"]}), flush=True)
        del keep
        torch.cuda.empty_cache()
    undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
