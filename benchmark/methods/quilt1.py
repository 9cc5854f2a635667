"""QUILT1 diploid imputation (`method`: `quilt1`): what the harness takes
of a method, found by the configuration's `method` key. A method module
gives

- `make_world(seed, config, traffic)`: the run's inputs (world.World);
- `batch_work(config, traffic, reads_per_batch)`: bytes and operations a
  batch, from the algorithm's sizes (work.py);
- `plan(seed, config, world)`: what the comparison keeps, drawn from the
  seed;
- `recorder(program, plan, config)`: the program's state recorder for it;
- `state(recorder, config)`: the recorded state on the host;
- `compare(state, world, idx, dosages, config, device, dtype)`: the
  numbers that decide `correct` (`numbers`), with what they were read from;
- `summary(compare, state)`: one line for standard error.

A method the port runs another way (QUILT2's msPBWT selection, NIPT's three
latent haplotypes, HLA typing) comes as a module of its own beside this."""
from __future__ import annotations

from typing import Dict

import torch

from .. import check, work
from ..reference import hmm
from ..world import SNPS_PER_GRID, make_world  # noqa: F401  (the method's world)

NL = 2                      # latent haplotypes of a diploid sample


def sizes(config: Dict, traffic: Dict, reads_per_batch: float) -> Dict:
    """The sizes the work counts take (work.batch_work)."""
    imp = config["impute"]
    n_its = int(imp["small_ref_panel_gibbs_iterations"]) + 1
    blocks = {int(b) - 1 for b in imp.get("small_ref_panel_block_gibbs_iterations", [3, 6, 9])}
    return {"S": int(traffic["sample_batch"]), "C": int(imp["nGibbsSamples"]), "nl": NL,
            "G": -(-int(config["nSNPs"]) // SNPS_PER_GRID), "Ksub": int(imp["Ksubset"]),
            "K": int(config["K"]), "n_its": n_its,
            "n_alpha": len({b for b in blocks if 0 <= b < n_its} | {n_its - 1}),
            "n_calls": 2 * int(imp["n_seek_its"]), "reads": float(reads_per_batch),
            "K_top": max(8, int(imp.get("K_top_matches", 5)))}


def batch_work(config: Dict, traffic: Dict, reads_per_batch: float) -> Dict:
    return work.batch_work(sizes(config, traffic, reads_per_batch))


def plan(seed: int, config: Dict, world) -> Dict:
    return check.plan(seed, config["impute"], len(world.batches[0]),
                      sum(r.n_reads for r in world.reads) / len(world.reads))


def recorder(program, plan: Dict, config: Dict):
    return program.Recorder(plan["sweeps"], plan["rows"], int(config["impute"]["nGibbsSamples"]))


def state(rec, config: Dict) -> Dict:
    return rec.state(int(config["K"]))


def compare(state: Dict, world, idx, dosages, config: Dict, device,
            dtype=torch.float64) -> Dict:
    """The numbers of check.py for the batch `idx` of the world, whose
    program dosages are `dosages` and recorded state `state`, with the
    reference computed in `dtype`: {"numbers": {sweep_alpha_gap,
    wrong_draw_share, dosage_gap}, "sweep": check.sweep_numbers(...), "ref":
    the reference's dosages, and the tables and transitions it used}."""
    imp = config["impute"]
    ref_error = float(config["ref_error"])
    tables = [hmm.sample_tables(world.reads[i].u, world.reads[i].bq, world.reads[i].offsets,
                                ref_error) for i in idx]
    stay, jump = hmm.transitions(world.pos, config)
    sweep = check.sweep_numbers(state, tables, world.rhb, stay, jump,
                                float(imp.get("maxDifferenceBetweenReads", 1e10)),
                                dtype=dtype, device=device)
    ref = check.reference_dosages(state, tables, hmm.panel_words_T(world.rhb, device), stay,
                                  jump, imp, ref_error, int(config["nSNPs"]), dtype=dtype)
    return {"numbers": {"sweep_alpha_gap": sweep["alpha_gap"],
                        "wrong_draw_share": sweep["wrong_share"],
                        "dosage_gap": check.dosage_number(dosages, ref)},
            "sweep": sweep, "ref": ref, "tables": tables, "stay": stay, "jump": jump}


def summary(cmp: Dict, state: Dict) -> str:
    sw = cmp["sweep"]
    return (f"{sw['reads']} draws judged in {len(state['sweeps'])} sweeps x "
            f"{len(state['rows'])} chains of {len({r // state['C'] for r in state['rows']})} "
            f"samples, {sw['wrong']} wrong (largest gap {sw['gap']!r}); largest "
            f"forward-probability gap of a row {sw['alpha_max']!r}; "
            f"{len(cmp['ref'])} samples' dosages, imputed in groups of {state['groups']}")
