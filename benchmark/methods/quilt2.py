"""QUILT2 diploid imputation with its defaults (`method`: `quilt2`): the
msPBWT selection of the haplotype subsets and the rare/common split, whose
seek loop runs on the common SNPs and whose output comes from one all-SNP
Gibbs call after the seek loop (and one after the phasing pass). The
functions methods/quilt1.py lists, for this path:

- `make_world`: the all-SNP world: the founder-mosaic panel of world.py on
  the common SNPs, rare sites between them with their carriers, truths
  and reads over every site;
- `batch_work`: the seek calls' sweeps ("gibbs"), the all-SNP calls'
  ("rare"), no full-panel FB ("fb");
- `plan`, `recorder`, `state`: what the comparison keeps of the batch in
  flight: each Gibbs call's subset, final labels and haplotype dosages
  (seek and all-SNP calls apart), a few sweeps of each kind, and every
  msPBWT selection's symbols, reported matches, retained subsets,
  generator state and new haps;
- `compare`: the numbers that decide `correct`, against
  reference/quilt2.py and reference/hmm.py;
- `summary`; and `control`, the same numbers with the reference in
  bfloat16 in the program's place (the limits were set from it).
"""
from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from .. import check, work
from .. import world as _world
from ..reference import hmm
from ..reference import quilt2 as ref

NL = 2
SNPS_PER_GRID = _world.SNPS_PER_GRID


# ---------------------------------------------------------------------------
# The world
# ---------------------------------------------------------------------------

@dataclass
class World(_world.World):
    """world.World over every site, with the panel's common SNPs as the
    world made them: rhb_common [K, nSNPs_common / 32] uint32 and
    snp_is_common [nSNPs] bool."""

    rhb_common: np.ndarray = None
    snp_is_common: np.ndarray = None


def _require_device_build() -> None:
    """Stop unless the program builds the all-SNP panel on the card."""
    from .. import program
    if getattr(program._context, "all_snp_panel_device", None) is None:
        raise RuntimeError(
            "the program builds its all-SNP panel on the host (its region context has no "
            "all_snp_panel_device): at this panel's size that outlasts a run")


def _spread(per: int) -> np.ndarray:
    """[256] uint32: the 8 bits of a byte moved to every per-th bit."""
    v = np.arange(256, dtype=np.uint32)
    return sum(((v >> i) & 1) << np.uint32(per * i) for i in range(8)).astype(np.uint32)


def rare_carriers(rng: np.random.Generator, rhb_common: np.ndarray, n_rare_per_grid: int,
                  k_max: int, singleton_share: float) -> List[np.ndarray]:
    """The carriers of each rare site, common grid by common grid
    (n_rare_per_grid sites a grid, in site order): an alternate-allele count
    k, 1 on a share singleton_share of the sites and otherwise drawn with
    weight 1/k over 2..k_max, and k carriers drawn without replacement
    among the haplotypes whose word at that grid equals an anchor's drawn
    at random (the lineage of one founder, as a new mutation on it), fewer
    where the lineage is smaller."""
    K, G = rhb_common.shape
    w = 1.0 / np.arange(2, k_max + 1)
    out = []
    for g in range(G):
        words = rhb_common[:, g]
        order = np.argsort(words, kind="stable")
        sw = words[order]
        ks = np.where(rng.random(n_rare_per_grid) < singleton_share, 1,
                      rng.choice(k_max - 1, size=n_rare_per_grid, p=w / w.sum()) + 2)
        anchors = words[rng.integers(0, K, size=n_rare_per_grid)]
        lo = np.searchsorted(sw, anchors, side="left")
        hi = np.searchsorted(sw, anchors, side="right")
        for k, a, b in zip(ks, lo, hi):
            out.append(np.sort(order[a + rng.choice(b - a, size=min(int(k), b - a),
                                                    replace=False)]))
    return out


def make_world(seed: int, config: Dict, traffic: Dict) -> World:
    """The world of a quilt2 configuration: the packed panel over all
    nSNPs sites, snp_spacing_bp apart, of which every (rare_sites_per_gap
    + 1)-th, from the first, is a common SNP of world.py's founder mosaic
    and the rest are rare (rare_carriers, under rare_af_threshold); the
    pool's truths copy panel haplotypes over every site, and its reads are
    world.py's over every site. The seed draws the panel, the rare sites,
    the truths and the base errors; the read layouts are the mix's own."""
    _require_device_build()
    rng = np.random.default_rng(int(seed) % (1 << 63))
    K, nSNPs = int(config["K"]), int(config["nSNPs"])
    per = int(config["rare_sites_per_gap"]) + 1
    if per != 4 or nSNPs % (per * SNPS_PER_GRID):
        raise ValueError("a quilt2 world puts 3 rare sites after each common SNP, "
                         f"over whole grids: got rare_sites_per_gap {per - 1}, nSNPs {nSNPs}")
    G_common = nSNPs // per // SNPS_PER_GRID
    panel = config["panel"]
    rhb_c = _world.fast_packed_panel(rng, K, G_common, n_founders=int(panel["n_founders"]),
                                     switch=float(panel["switch"]),
                                     mutation_per_bit=float(panel["mutation_per_bit"]))
    # common SNP j is site per * j: byte b of common word w holds all-SNP grid 4w + b
    rhb = _spread(per)[rhb_c.view(np.uint8)]
    k_max = int(np.ceil(float(config["impute"]["rare_af_threshold"]) * K)) - 1
    carriers = rare_carriers(rng, rhb_c, SNPS_PER_GRID * (per - 1), k_max,
                             float(config["rare_singleton_share"]))
    is_common = np.zeros(nSNPs, bool)
    is_common[::per] = True
    rare = np.flatnonzero(~is_common)
    lens = np.array([len(c) for c in carriers])
    site = np.repeat(rare, lens)
    np.bitwise_or.at(rhb, (np.concatenate(carriers), site // SNPS_PER_GRID),
                     np.left_shift(np.uint32(1), (site % SNPS_PER_GRID).astype(np.uint32)))
    pos = _world.positions(config)
    S, n_b = int(traffic["sample_batch"]), int(traffic["pool_batches"])
    lay_rng = np.random.default_rng(int(traffic["layout_seed"]))
    layouts = [_world.read_layout(lay_rng, pos, float(traffic["coverage"]),
                                  int(traffic["read_length_bp"])) for _ in range(S * n_b)]
    order = np.concatenate([b * S + rng.permutation(S) for b in range(n_b)])
    truths, reads = [], []
    for i in order:
        truth = _world.packed_truth_mosaic(rng, rhb, nSNPs, 2, float(config["truth_switch_rate"]))
        truths.append(truth)
        reads.append(_world.reads_of(rng, truth, pos, *layouts[i], int(traffic["read_length_bp"]),
                                     int(traffic["phred"])))
    return World(rhb=rhb, pos=pos, truths=truths, reads=reads, sample_batch=S,
                 rhb_common=rhb_c, snp_is_common=is_common)


# ---------------------------------------------------------------------------
# Work counts
# ---------------------------------------------------------------------------

def _sweeps(G: int, B: int, K: int, reads: float, n_its: int, n_alpha: int, n_calls: int):
    """(bytes, operations) of n_calls Gibbs calls of n_its sweeps each, of
    which n_alpha keep their forward probabilities."""
    nb = nf = 0.0
    for want_alpha, n in ((True, n_alpha), (False, n_its - n_alpha)):
        fb_, ff_ = work.fwd_sweep_work(G, B, NL, K, reads, reads, want_alpha)
        bb_, bf_ = work.bwd_sweep_work(G, B * NL, K)
        nb += n * (fb_ + bb_)
        nf += n * (ff_ + bf_)
    return n_calls * nb, n_calls * nf


def batch_work(config: Dict, traffic: Dict, reads_per_batch: float) -> Dict:
    """Bytes and operations a batch: "gibbs", the 2 x n_seek_its seek calls
    over the common grids (block moves as configured; every 150 bp read
    covers two or more common SNPs 60 bp apart, so all the batch's reads);
    "rare", the two all-SNP calls over every grid (no block moves: only
    the last sweep keeps its forward probabilities); "fb": none."""
    imp = config["impute"]
    C = int(imp["nGibbsSamples"])
    B = int(traffic["sample_batch"]) * C
    reads = float(reads_per_batch) * C           # every chain steps through its sample's reads
    n_its = int(imp["small_ref_panel_gibbs_iterations"]) + 1
    blocks = {int(b) - 1 for b in imp["small_ref_panel_block_gibbs_iterations"]}
    n_alpha = len({b for b in blocks if 0 <= b < n_its} | {n_its - 1})
    G_all = int(config["nSNPs"]) // SNPS_PER_GRID
    G_common = G_all // (int(config["rare_sites_per_gap"]) + 1)
    K = int(imp["Ksubset"])
    return {"gibbs": _sweeps(G_common, B, K, reads, n_its, n_alpha, 2 * int(imp["n_seek_its"])),
            "rare": _sweeps(G_all, B, K, reads, n_its, 1, 2),
            "fb": (0.0, 0.0)}


# ---------------------------------------------------------------------------
# What the comparison keeps
# ---------------------------------------------------------------------------

def plan(seed: int, config: Dict, world) -> Dict:
    """check.plan's chain rows and seek sweeps, and the last sweep of one
    of the two all-SNP calls (the only one that keeps its forward
    probabilities), drawn from the seed."""
    imp = config["impute"]
    base = check.plan(seed, imp, len(world.batches[0]),
                      sum(r.n_reads for r in world.reads) / len(world.reads))
    rng = np.random.default_rng([int(seed) % (1 << 63), 24])
    n_its = int(imp["small_ref_panel_gibbs_iterations"]) + 1
    return {"rows": base["rows"],
            "sweeps": [("seek", c, it) for c, it in base["sweeps"]]
            + [("rare", int(rng.integers(2)), n_its - 1)]}


class Recorder:
    """The batch in flight's state that the reference follows (module
    docstring), through the handles program.py holds (and the modules they
    have loaded); each wrapper copies small tensors and changes nothing the
    program computes. Per group of samples engine/driver.py imputes (a slice of
    the batch; made again when the engine repeats a group): each Gibbs
    call's padded subset, its read emissions' maxDifferenceBetweenReads
    (from the whole-panel cache's subset or the subset words' build),
    and for the kept rows its final labels and haplotype dosages; the
    kept sweeps; every selection. A call is an all-SNP call when its grids
    are not the common ones."""

    def __init__(self, program, plan: Dict, C: int, G_common: int):
        self.program = program
        self.sweeps = set(tuple(s) for s in plan["sweeps"])
        self.rows = list(plan["rows"])
        self.C = C
        self.G_common = G_common
        self._orig = {}
        self.region: Dict = {}
        self.begin()

    def begin(self) -> None:
        self.parts: List[Dict] = []

    def _group(self, n_samples: int) -> None:
        start = sum(p["size"] for p in self.parts)
        self.parts.append({"start": start, "size": n_samples})
        self._attempt()

    def _attempt(self) -> None:
        p = self.parts[-1]
        lo, hi = p["start"] * self.C, (p["start"] + p["size"]) * self.C
        p.update(n={"seek": -1, "rare": -1}, kind="seek", it=0, md=None, which={}, calls={},
                 sweep={}, selects=[], matches=[],
                 kept=[r for r in self.rows if lo <= r < hi],
                 local=[r - lo for r in self.rows if lo <= r < hi])

    def install(self) -> "Recorder":
        prog, rec = self.program, self
        _driver, _batch, _context, _gibbs = prog._driver, prog._batch, prog._context, prog._gibbs
        ms = sys.modules[_batch.select_new_haps_mspbwt_batch.__module__]
        batched, once = _driver.impute_samples_batched, _batch._impute_once
        run_chains, fwd = _context.run_gibbs_chains, _gibbs.fwd_sweep
        gather, emat = _batch.gather_words, _batch.emat_read_from_bits
        lem_subset = _batch.lem_subset
        select, match = _batch.select_new_haps_mspbwt_batch, ms.match_z_batch

        def kind_of(G):
            return "seek" if G == rec.G_common else "rare"

        def batched_w(ctx, reads_list, *a, **kw):
            rec._group(len(reads_list))
            rec.region = {"rare_sites": getattr(ctx, "rare_sites", None),
                          "rare_carriers": getattr(ctx, "rare_carriers", None),
                          "sites": len(ctx.prep.snp_is_common), "grids_all": ctx.nGrids_all}
            return batched(ctx, reads_list, *a, **kw)

        def once_w(*a, **kw):
            rec._attempt()
            return once(*a, **kw)

        def gather_w(rhb, which):
            p = rec.parts[-1]
            kind = kind_of(rhb.shape[1])
            p["which"][(kind, p["n"][kind] + 1)] = which.detach().clone()
            return gather(rhb, which)

        def emat_w(words, u_pad, lr, la, max_diff, *a, **kw):
            rec.parts[-1]["md"] = float(max_diff)
            return emat(words, u_pad, lr, la, max_diff, *a, **kw)

        def lem_subset_w(lem_full, flat_idx, max_diff, *a, **kw):
            rec.parts[-1]["md"] = float(max_diff)
            return lem_subset(lem_full, flat_idx, max_diff, *a, **kw)

        def run_chains_w(layout, *a, **kw):
            p = rec.parts[-1]
            kind = kind_of(layout.G)
            p["n"][kind] += 1
            p["kind"], p["it"] = kind, 0
            if (kind, p["n"][kind]) not in p["which"]:        # an underflow's repeat
                p["which"][(kind, p["n"][kind])] = p["which"][(kind, p["n"][kind] - 1)]
            out = run_chains(layout, *a, **kw)
            if p["local"]:
                r = torch.as_tensor(p["local"], device=out.H.device)
                p["calls"][(kind, p["n"][kind])] = {
                    "H": out.H.index_select(0, r), "hap_dos": out.hap_dos.index_select(0, r),
                    "K_real": int(a[7]), "md": p["md"]}
            return out

        def fwd_w(lemg, beta, lem_pad, slots, *a, **kw):
            out = fwd(lemg, beta, lem_pad, slots, *a, **kw)
            p = rec.parts[-1]
            key = (p["kind"], p["n"][p["kind"]], p["it"])
            if key in rec.sweeps and p["local"]:
                r = torch.as_tensor(p["local"], device=slots.device)
                B = slots.shape[3]
                p["sweep"][key] = {"slots": slots.index_select(3, r),
                                   "h_out": out[2].index_select(2, r),
                                   "alphas": torch.stack([out[1].index_select(1, h * B + r)
                                                          for h in range(out[1].shape[1] // B)],
                                                         1),
                                   "it_mode": int(kw.get("it_mode", 2)),
                                   "K_real": int(kw["K_real"])}
            p["it"] += 1
            return out

        def match_w(index, Z, *a, **kw):
            res = match(index, Z, *a, **kw)
            rec.parts[-1]["matches"].append(res)
            return res

        def select_w(ms_indices, panel, symbols_all, Knew, K, prev_list, rng, *a, **kw):
            p = rec.parts[-1]
            p["matches"] = []
            state = rng.bit_generator.state
            news = select(ms_indices, panel, symbols_all, Knew, K, prev_list, rng, *a, **kw)
            p["selects"].append({"call": p["n"]["seek"], "z": np.array(symbols_all),
                                 "prev": [np.array(x) for x in prev_list], "rng": state,
                                 "news": [np.array(x) for x in news], "Knew": int(Knew),
                                 "K": int(K), "grids": [np.array(i.grids) for i in ms_indices],
                                 "cp_cols": [np.array(i.cp_cols) for i in ms_indices],
                                 "matches": p["matches"]})
            return news

        self._orig = {(_driver, "impute_samples_batched"): batched,
                      (_batch, "_impute_once"): once, (_batch, "gather_words"): gather,
                      (_batch, "emat_read_from_bits"): emat, (_batch, "lem_subset"): lem_subset,
                      (_context, "run_gibbs_chains"): run_chains, (_gibbs, "fwd_sweep"): fwd,
                      (ms, "match_z_batch"): match,
                      (_batch, "select_new_haps_mspbwt_batch"): select}
        for (mod, name), fn in (((_driver, "impute_samples_batched"), batched_w),
                                ((_batch, "_impute_once"), once_w),
                                ((_batch, "gather_words"), gather_w),
                                ((_batch, "emat_read_from_bits"), emat_w),
                                ((_batch, "lem_subset"), lem_subset_w),
                                ((_context, "run_gibbs_chains"), run_chains_w),
                                ((_gibbs, "fwd_sweep"), fwd_w), ((ms, "match_z_batch"), match_w),
                                ((_batch, "select_new_haps_mspbwt_batch"), select_w)):
            setattr(mod, name, fn)
        return self

    def uninstall(self) -> None:
        for (mod, name), fn in self._orig.items():
            setattr(mod, name, fn)
        self._orig = {}

    def state(self, K: int) -> Dict:
        """The batch's record on the host, the kept rows in the order of
        `rows`: "calls" {(kind, call): which [rows, Kp] (panel indices),
        labels H [rows, R], hap_dos [rows, nl, G * 32], K_real, md};
        "sweeps" {(kind, call, sweep): as program.Recorder.state's};
        "selects": per group, its selections (row0: the group's first chain
        row in the batch)."""
        at = {r: (p, j) for p in self.parts for j, r in enumerate(p["kept"])}
        calls = {}
        for key in sorted({k for p in self.parts for k in p["calls"]}):
            per = [(at[r][0], at[r][1]) for r in self.rows]
            calls[key] = {
                "which": np.stack([p["which"][key][p["local"][j]].cpu().numpy() % K
                                   for p, j in per]),
                "H": [p["calls"][key]["H"][j].cpu().numpy() for p, j in per],
                "hap_dos": np.stack([p["calls"][key]["hap_dos"][j].cpu().numpy()
                                     for p, j in per]),
                "K_real": per[0][0]["calls"][key]["K_real"],
                "md": [p["calls"][key]["md"] for p, _ in per]}
        sweeps = {}
        for key in sorted({k for p in self.parts for k in p["sweep"]}):
            per = [(at[r][0]["sweep"][key], at[r][1]) for r in self.rows]
            first = per[0][0]
            sweeps[key] = {"it_mode": first["it_mode"], "K_real": first["K_real"],
                           "slots": [v["slots"][..., j].cpu().numpy() for v, j in per],
                           "h_out": [v["h_out"][..., j].cpu().numpy() for v, j in per],
                           "alphas": [v["alphas"][:, :, j].cpu().numpy() for v, j in per]}
        selects = [{"row0": p["start"] * self.C, "list": p["selects"]} for p in self.parts]
        return {"calls": calls, "sweeps": sweeps, "selects": selects, "rows": list(self.rows),
                "C": self.C, "groups": [p["size"] for p in self.parts], "region": self.region}


def recorder(program, plan: Dict, config: Dict) -> Recorder:
    G_all = int(config["nSNPs"]) // SNPS_PER_GRID
    return Recorder(program, plan, int(config["impute"]["nGibbsSamples"]),
                    G_all // (int(config["rare_sites_per_gap"]) + 1))


def state(rec: Recorder, config: Dict) -> Dict:
    return rec.state(int(config["K"]))


# ---------------------------------------------------------------------------
# The comparison
# ---------------------------------------------------------------------------

def _split(world: World, config: Dict, device) -> np.ndarray:
    """The rare/common split the method makes of the world's panel (MAF at
    or above rare_af_threshold: common); it has to be the world's own."""
    w = torch.as_tensor(world.rhb.view(np.int32), device=device)
    counts = torch.stack([((w >> b) & 1).sum(0) for b in range(SNPS_PER_GRID)], 1)
    af = (counts.reshape(-1)[:len(world.pos)].double() / w.shape[0]).cpu().numpy()
    common = np.minimum(af, 1 - af) >= float(config["impute"]["rare_af_threshold"])
    if not np.array_equal(common, world.snp_is_common):
        raise ValueError(f"the panel's rare/common split ({int((~common).sum())} rare sites) is "
                         f"not the world's ({int((~world.snp_is_common).sum())})")
    return common


def _axes(world: World, idx, config: Dict, common: np.ndarray) -> Dict:
    """The two axes the calls run on: {kind: (read tables of the batch's
    samples, packed panel, stay, jump, nSNPs)}."""
    ref_error = float(config["ref_error"])
    t_all = [hmm.sample_tables(world.reads[i].u, world.reads[i].bq, world.reads[i].offsets,
                               ref_error) for i in idx]
    t_com = [ref.common_tables(world.reads[i].u, world.reads[i].bq, world.reads[i].offsets,
                               common, ref_error) for i in idx]
    s_all, j_all = hmm.transitions(world.pos, config)
    s_com, j_com = hmm.transitions(world.pos[common], config)
    return {"seek": (t_com, world.rhb_common, s_com, j_com, int(common.sum())),
            "rare": (t_all, world.rhb, s_all, j_all, len(world.pos))}


def _view(state: Dict, kind: str) -> Dict:
    """The state of one kind of call as check.sweep_numbers reads it."""
    return {"C": state["C"], "rows": state["rows"],
            "which": {c: v["which"] for (k, c), v in state["calls"].items() if k == kind},
            "sweeps": {(c, it): v for (k, c, it), v in state["sweeps"].items() if k == kind}}


def _sweep_numbers(state: Dict, axes: Dict, max_diff: float, dtype, device) -> Dict:
    """check.sweep_numbers over the kept sweeps of both kinds of call:
    the median row gap, the largest, the draws judged and wrong, and each
    kind's own record ("by_kind")."""
    by_kind, rows, judged, wrong, gap = {}, [], 0, 0, 0.0
    for kind, (tables, rhb, stay, jump, _) in axes.items():
        view = _view(state, kind)
        if not view["sweeps"]:
            continue
        sw = check.sweep_numbers(view, tables, rhb, stay, jump, max_diff, dtype=dtype,
                                 device=device)
        by_kind[kind] = sw
        for (call, it), rec in view["sweeps"].items():
            prog_a = np.stack([a[..., :rec["K_real"]] for a in rec["alphas"]], 1)
            rows.extend(check.row_gaps(prog_a, sw["p"][(call, it)][4]))
        judged, wrong, gap = judged + sw["reads"], wrong + sw["wrong"], max(gap, sw["gap"])
    return {"alpha_gap": float(np.median(rows)) if rows else float("nan"),
            "alpha_max": float(max(rows, default=float("nan"))), "reads": judged, "wrong": wrong,
            "wrong_share": wrong / judged if judged else float("nan"), "gap": gap,
            "by_kind": by_kind}


def _hap_dosages(state: Dict, axes: Dict, config: Dict, dtype, device) -> Dict:
    """{(kind, call): the reference's haplotype dosages [rows, nl, nSNPs]
    of the kept rows, from the call's subsets and final labels}."""
    C = state["C"]
    out = {}
    for (kind, call), v in state["calls"].items():
        tables, rhb, stay, jump, n = axes[kind]
        samp = [r // C for r in state["rows"]]
        if len(set(v["md"])) != 1:
            raise ValueError(f"the kept rows of {kind} call {call} ran with several "
                             f"maxDifferenceBetweenReads: {sorted(set(v['md']))}")
        out[(kind, call)] = ref.gibbs_hap_dosages(
            [tables[s] for s in samp], rhb, v["which"][:, :v["K_real"]],
            [h[:tables[s].n_reads] for h, s in zip(v["H"], samp)], stay, jump, v["md"][0],
            float(config["ref_error"]), n, nl=NL, dtype=dtype, device=device)
    return out


def _select_numbers(state: Dict, world: World, config: Dict, device) -> Dict:
    """The selections against reference/quilt2.py: (a) the kept rows whose
    symbols differ from those of their haplotype dosages, (b) the reported
    matches that are not matches, (c) the (query, index) scans whose
    reported matches differ from approach A's by brute force, and the
    (query, checkpoint column) pairs with a match of mspbwtL grids or more
    ending there where the scan reported none from the longest one's
    start, (d) the rows whose new haps differ from the ranking, interleave
    and fill recomputed; each as a share, and `gap` their sum."""
    imp = config["impute"]
    C, n_common = state["C"], int(world.snp_is_common.sum())
    dh = ref.DistinctHaps(world.rhb_common, device)
    hap_host = dh.hap.cpu().numpy()
    L = int(imp.get("mspbwtL", 3))
    scan = max(int(imp.get("mspbwtM", 1)), 4)        # neighbours a side (panel/mspbwt.py)
    n = dict(sym_rows=0, sym_bad=0, matches=0, false=0, scans=0, scan_differs=0, cols=0,
             missed=0, rows=0, differ=0, fill=0, picks=0)
    for part in state["selects"]:
        if not part["list"]:
            continue
        lo = part["row0"]
        hi = lo + len(part["list"][0]["z"])
        for sel in part["list"]:
            z = sel["z"]                                                 # [B, nl, G]
            dos = state["calls"].get(("seek", sel["call"]))
            kept = [(j, r - lo) for j, r in enumerate(state["rows"]) if lo <= r < hi]
            if dos is not None and kept:
                zr = ref.symbols(dos["hap_dos"][[j for j, _ in kept]], dh.table, n_common)
                n["sym_rows"] += len(kept)
                n["sym_bad"] += int((zr != z[[b for _, b in kept]]).any(axis=(1, 2)).sum())
            Zq = z.reshape(-1, z.shape[-1])
            per_query = [[] for _ in range(len(Zq))]
            for grids, cp_cols, res in zip(sel["grids"], sel["cp_cols"], sel["matches"]):
                Zi = Zq[:, grids]
                hi_idx = hap_host[:, grids]
                want, longest = ref.approach_a(
                    Zi, dh.hap[:, torch.as_tensor(grids, device=dh.hap.device)], cp_cols, L, scan)
                res = list(res) + [[]] * (len(Zi) - len(res))      # a query left unanswered
                for q, lst in enumerate(res):
                    per_query[q].extend(lst)
                    n["matches"] += len(lst)
                    n["false"] += ref.false_matches(Zi[q], lst, hi_idx, L)
                    n["scans"] += 1
                    n["scan_differs"] += set(lst) != set(want[q])
                cols, missed = ref.missed_checkpoints(longest, cp_cols, res, L)
                n["cols"] += cols
                n["missed"] += missed
            T = max(len(g) for g in sel["grids"])
            news = ref.select_rows(per_query, z.shape[1], T, sel["Knew"], sel["K"], sel["prev"],
                                   sel["rng"])
            nl = z.shape[1]
            for r, new in enumerate(sel["news"]):              # picks in no ranked list: fill
                ranked = {k for h in range(nl) for k, _, _ in per_query[r * nl + h]}
                n["fill"] += sum(int(k) not in ranked for k in new)
                n["picks"] += len(new)
            n["rows"] += len(news)
            n["differ"] += sum(int(not np.array_equal(a, b)) for a, b in zip(news, sel["news"]))
    share = {"symbols": n["sym_bad"] / max(n["sym_rows"], 1),
             "false_matches": n["false"] / max(n["matches"], 1),
             "scans_differ": n["scan_differs"] / max(n["scans"], 1),
             "missed_columns": n["missed"] / max(n["cols"], 1),
             "new_haps": n["differ"] / max(n["rows"], 1)}
    return {"gap": float(sum(share.values())) if n["rows"] else float("nan"),
            "share": share, "counts": n}


def _dosage_gap(prog: Dict, refd: Dict) -> float:
    """The largest |program - reference| haplotype dosage over every kept
    row, latent haplotype, site and call (a non-finite one counts as 1)."""
    worst = 0.0
    for key, r in refd.items():
        p = prog[key]["hap_dos"][:, :, :r.shape[2]].astype(np.float64)
        if not np.all(np.isfinite(p)):
            return 1.0
        worst = max(worst, float(np.abs(p - r).max()))
    return worst


def compare(state: Dict, world: World, idx, dosages, config: Dict, device,
            dtype=torch.float64) -> Dict:
    """The numbers that decide `correct` for the batch `idx`, with the
    reference in `dtype`: sweep_alpha_gap and wrong_draw_share as QUILT1's
    (check.sweep_numbers) over the kept sweeps of both kinds of call;
    hap_dosage_gap, the largest gap of the kept rows' haplotype dosages
    after every Gibbs call against reference/quilt2.py's; select_gap, the
    selections' shares of faults (_select_numbers). `dosages`, the
    batch's output, is r2's: it is the mean of the all-SNP call's hap
    dosages that hap_dosage_gap holds."""
    ref.no_tf32()                       # the sweeps' products too (reference/hmm.py)
    common = _split(world, config, device)
    axes = _axes(world, idx, config, common)
    max_diff = float(config["impute"].get("maxDifferenceBetweenReads", 1e10))
    sweep = _sweep_numbers(state, axes, max_diff, dtype, device)
    refd = _hap_dosages(state, axes, config, dtype, device)
    sel = _select_numbers(state, world, config, device)
    return {"numbers": {"sweep_alpha_gap": sweep["alpha_gap"],
                        "wrong_draw_share": sweep["wrong_share"],
                        "hap_dosage_gap": _dosage_gap(state["calls"], refd),
                        "select_gap": sel["gap"]},
            "sweep": sweep, "ref": refd, "select": sel, "axes": axes}


def summary(cmp: Dict, state: Dict) -> str:
    sw, sel = cmp["sweep"], cmp["select"]
    c, reg = sel["counts"], state.get("region", {})
    return (f"{sw['reads']} draws judged in {len(state['sweeps'])} sweeps "
            f"({', '.join(f'{k} {c}/{it}' for k, c, it in sorted(state['sweeps']))}) x "
            f"{len(state['rows'])} chains, {sw['wrong']} wrong (largest gap {sw['gap']!r}); "
            f"largest forward-probability gap of a row {sw['alpha_max']!r}; hap dosages of "
            f"{len(cmp['ref'])} calls; selections: {c['rows']} rows, {c['matches']} matches "
            f"({c['false']} false), {c['scan_differs']} of {c['scans']} scans unlike approach A's, "
            f"{c['cols']} checkpoint columns with a long match ({c['missed']} missed), {c['sym_bad']} of {c['sym_rows']} rows' symbols and {c['differ']} rows' "
            f"new haps differ, {c['fill']} of {c['picks']} picks random fill; rare/common: "
            f"{reg.get('rare_sites')} rare sites of {reg.get('sites')}, "
            f"{reg.get('rare_carriers')} carriers, the all-SNP calls on {reg.get('grids_all')} "
            f"grids; groups {state['groups']}")


def control(keep: Dict, device) -> Dict:
    """The control's numbers on the state a run kept (harness.run_cell's
    `keep`): the reference in bfloat16 in the program's place, against the
    float64 reference: its forward probabilities (median row gap) and its
    draws (the labels its own P(label 0) gives with the program's
    uniforms), its haplotype dosages; the selection, integer work with no
    precision to lower, reads as the program's."""
    cmp, st = keep["compare"], keep["state"]
    max_diff = float(keep["config"]["impute"].get("maxDifferenceBetweenReads", 1e10))
    low = _sweep_numbers(st, cmp["axes"], max_diff, torch.bfloat16, device)
    rows, wrong, judged = [], 0, 0
    for kind, sw in low["by_kind"].items():
        for key, (p_low, lab_in, _, u, a_low) in sw["p"].items():
            p_ref, a_ref = cmp["sweep"]["by_kind"][kind]["p"][key][0], \
                cmp["sweep"]["by_kind"][kind]["p"][key][4]
            for pl, li, uu, pr in zip(p_low, lab_in, u, p_ref):
                g = hmm.decision_gaps(hmm.control_draws(pl, uu, li), li, uu, pr)
                wrong += int((g > 0).sum())
                judged += int(np.isfinite(pr).sum())
            rows.extend(check.row_gaps(a_low, a_ref))
    d_low = _hap_dosages(st, cmp["axes"], keep["config"], torch.bfloat16, device)
    return {"sweep_alpha_gap": float(np.median(rows)), "wrong_draw_share": wrong / max(judged, 1),
            "hap_dosage_gap": max(float(np.abs(d_low[k] - cmp["ref"][k]).max()) for k in d_low),
            "select_gap": cmp["numbers"]["select_gap"]}
