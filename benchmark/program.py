"""The system under test, as the benchmark drives it. This is the only
module of the benchmark that imports quilt_tpu_torch.

- `prepare`: the port's region set-up of the benchmark's panel
  (panel/prepare.py:prepare_panel on the packed words, as the CLI's
  prepare step builds it from a panel VCF), then the region context.
  QUILT2's prepare options are read from the run's ImputeConfig (the
  configuration's `impute` block): `use_mspbwt` builds the msPBWT
  indices, `impute_rare_common` splits the panel at `rare_af_threshold`
  (`rare_common_split`, the stand-in for the VCF ingest's split).
- `sample_reads`: the reads on the program's grids, the all-SNP ones
  under rare/common.
- `impute`: one batch through engine/driver.py:quilt_impute, as the CLI's
  `impute` calls it, with the bgzipped VCF written over one file.
- `Recorder`: wrappers around seven of the port's functions that keep,
  for the batch in flight, the state the reference follows: the haplotype
  subset of each Gibbs call, the labels before and after a few forward
  sweeps chosen from the seed (with their uniforms) and the forward
  probabilities those sweeps keep, and the labels each full-panel FB call
  starts from, for each group of samples the driver imputes the batch in.
  The wrappers copy small tensors and change nothing the program computes.
- `SectionEvents`: CUDA events at the edges of the engine's own timed
  sections (utils/log.py:_Section), and a profiler range of the same name,
  so that a traced run reads each layer's device time without an edit to
  the program.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np
import torch

import quilt_tpu_torch.engine.batch as _batch
import quilt_tpu_torch.engine.context as _context
import quilt_tpu_torch.engine.driver as _driver
import quilt_tpu_torch.kernels.gibbs as _gibbs
import quilt_tpu_torch.utils.log as _log
from quilt_tpu_torch.config import ImputeConfig
from quilt_tpu_torch.engine.driver import _region_context
from quilt_tpu_torch.io.reads import SampleReads
from quilt_tpu_torch.panel.prepare import prepare_panel

from .world import SNPS_PER_GRID, World


def build_kernels(device) -> float:
    """Seconds to build every CUDA kernel of the port not yet built in the
    checkout (quilt_tpu_torch/_build.py:build_all, one nvcc a source, all
    at once); 0 without a card. The engine would otherwise build each on
    its first launch, inside the warm-up batch."""
    if torch.device(device).type != "cuda":
        return 0.0
    from quilt_tpu_torch import _build
    t = time.monotonic()
    _build.build_all()
    return time.monotonic() - t


def panel_af(rhb: np.ndarray, nSNPs: int, device) -> np.ndarray:
    """Alternate-allele frequency [nSNPs] of the packed panel, counted on
    the device (the panel VCF's AF, which a VCF ingest reads)."""
    w = torch.as_tensor(rhb.view(np.int32), device=device)
    counts = torch.stack([((w >> b) & 1).sum(0) for b in range(SNPS_PER_GRID)], 1)
    return (counts.reshape(-1)[:nSNPs].double() / rhb.shape[0]).cpu().numpy()


def impute_config(config: Dict, traffic: Dict, seed: int, timing: bool) -> ImputeConfig:
    """The configuration's QUILT parameters, the traffic's batch, and the
    program's own seed (from the run's)."""
    return ImputeConfig(**config["impute"], sample_batch=int(traffic["sample_batch"]),
                        seed=int(seed) % (2 ** 31 - 1), print_extra_timing_information=timing,
                        make_plots=False, verbose=False)


def rare_common_split(rhb: np.ndarray, af_all: np.ndarray, threshold: float, device,
                      chunk_snps: int = 512) -> Dict:
    """The rare/common split of the packed panel, as a panel VCF's streaming
    ingest returns it (io/native.py:read_panel_vcf_packed), made on the
    device `chunk_snps` SNPs at a time: `snp_is_common` (MAF >= threshold,
    from the alternate-allele frequencies af_all), `rhb_t` (the common SNPs'
    packed words), `rare_offsets` int64 and `rare_flat` int32 (each rare
    SNP's alternate-allele carriers, in haplotype order)."""
    maf = np.minimum(af_all, 1.0 - af_all)
    common = maf >= threshold
    K = rhb.shape[0]
    w = torch.as_tensor(rhb.view(np.int32), device=device)

    def bits(snps: np.ndarray) -> torch.Tensor:
        """[K, len(snps)] alleles (0 / 1) of the SNPs."""
        s = torch.as_tensor(snps, dtype=torch.int64, device=device)
        return (w[:, s >> 5] >> (s & 31)) & 1

    idx = np.flatnonzero(common)
    G = -(-len(idx) // SNPS_PER_GRID)
    rhb_t = np.zeros((K, G), dtype=np.uint32)
    shifts = torch.arange(SNPS_PER_GRID, device=device, dtype=torch.int64)
    step = max(1, chunk_snps // SNPS_PER_GRID)
    for g0 in range(0, G, step):
        g1 = min(G, g0 + step)
        b = bits(idx[g0 * SNPS_PER_GRID:g1 * SNPS_PER_GRID])
        b = torch.nn.functional.pad(b, (0, (g1 - g0) * SNPS_PER_GRID - b.shape[1]))
        words = (b.view(K, g1 - g0, SNPS_PER_GRID) << shifts).sum(-1)
        rhb_t[:, g0:g1] = words.cpu().numpy().astype(np.uint32)
    rare = np.flatnonzero(~common)
    counts, flat = [np.zeros(0, np.int64)], [np.zeros(0, np.int32)]
    for r0 in range(0, len(rare), chunk_snps):
        b = bits(rare[r0:r0 + chunk_snps])
        counts.append(b.sum(0).cpu().numpy())
        flat.append(torch.nonzero(b.t())[:, 1].int().cpu().numpy())   # SNP by SNP, haps in order
    rare_offsets = np.zeros(len(rare) + 1, dtype=np.int64)
    np.cumsum(np.concatenate(counts), out=rare_offsets[1:])
    return {"snp_is_common": common, "rhb_t": rhb_t, "rare_offsets": rare_offsets,
            "rare_flat": np.concatenate(flat)}


def prepare(world: World, config: Dict, cfg: ImputeConfig, device):
    """The prepared reference of the world's panel and its region context
    (distinct-haplotype compression, transitions, device tensors). With
    neither of QUILT2's options set in `cfg`, prepare_panel gets the
    packed words, their frequencies and the map's numbers alone. Set-up
    stops where the reference lacks what `cfg` asks for, rather than run
    QUILT1 in QUILT2's place."""
    nSNPs = len(world.pos)
    K = world.rhb.shape[0]
    presplit = {"K": K, "af_all": panel_af(world.rhb, nSNPs, device), "rhb_t": world.rhb}
    quilt2 = {}
    if cfg.impute_rare_common:
        presplit.update(rare_common_split(world.rhb, presplit["af_all"],
                                          float(cfg.rare_af_threshold), device))
        quilt2.update(impute_rare_common=True, rare_af_threshold=float(cfg.rare_af_threshold))
    if cfg.use_mspbwt:
        quilt2["use_mspbwt"] = True
    prep = prepare_panel(
        config["chrom"], world.pos, np.array(["A"] * nSNPs), np.array(["G"] * nSNPs),
        presplit=presplit,
        nGen=float(config["nGen"]), expRate=float(config["expRate"]),
        minRate=float(config["minRate"]), maxRate=float(config["maxRate"]),
        ref_error=float(config["ref_error"]), **quilt2)
    for key, field in (("impute_rare_common", "snp_is_common"), ("use_mspbwt", "ms_indices")):
        if getattr(cfg, key) and getattr(prep, field) is None:
            raise ValueError(f"the configuration's impute block sets {key}, but the prepared "
                             f"reference has no {field}")
    _region_context(prep, cfg, device)
    return prep


def sample_reads(world: World, prep) -> List[SampleReads]:
    """The pool's reads as the program's read sets, their central grids
    snapped to the program's grids: the all-SNP grids where the reference
    has them (rare/common, as the CLI's impute loads reads), else its
    grids."""
    grid = prep.grid if prep.grid_all is None else prep.grid_all
    return [SampleReads.from_lists(*r.lists(), grid) for r in world.reads]


def impute(prep, reads: Sequence[SampleReads], names: Sequence[str], cfg: ImputeConfig,
           device, vcf_path: str):
    """(dosages [nSNPs] of each sample, the engine's section timings or None)."""
    out = _driver.quilt_impute(prep, list(reads), list(names), cfg, device,
                               output_filename=vcf_path)
    return [r.dosage for r in out.results], out.timing


def free(prep) -> None:
    """Drop the region context (the program's device state) of `prep`."""
    if hasattr(prep, "_torch_ctx_cache"):
        del prep._torch_ctx_cache
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class Recorder:
    """The state of the batch in flight that the reference follows (see the
    module docstring). `sweeps`: the (Gibbs call, sweep) pairs to keep;
    `rows`: the chain rows (sample * C + chain, in the batch) whose sweeps
    are kept; C: chains a sample.

    The driver may impute a batch as several groups of samples, one
    batched call each, where one Gibbs call's working set would not fit the
    device (engine/driver.py, `sample_batch` clamped from the free memory);
    the groups are consecutive slices of the batch. A group's record is
    made again when the engine repeats its call (`_impute_once`'s
    retries)."""

    def __init__(self, sweeps: Sequence[tuple], rows: Sequence[int], C: int):
        self.sweeps = set(tuple(s) for s in sweeps)
        self.rows = list(rows)
        self.C = C
        self._orig = {}
        self.begin()

    def begin(self) -> None:
        """A new batch."""
        self.parts: List[Dict] = []

    def _group(self, n_samples: int) -> None:
        start = sum(p["size"] for p in self.parts)
        self.parts.append({"start": start, "size": n_samples})
        self._attempt()

    def _attempt(self) -> None:
        p = self.parts[-1]
        lo, hi = p["start"] * self.C, (p["start"] + p["size"]) * self.C
        p.update(call=-1, it=0, fb_call=-1, which={}, sweep={}, labels={},
                 kept=[r for r in self.rows if lo <= r < hi],
                 local=[r - lo for r in self.rows if lo <= r < hi])

    def install(self) -> "Recorder":
        rec = self
        batched, once = _driver.impute_samples_batched, _batch._impute_once
        run_chains = _context.run_gibbs_chains
        fwd = _gibbs.fwd_sweep
        lem_subset, gather_words = _batch.lem_subset, _batch.gather_words
        gls = _batch.gls_from_labels_windowed

        def batched_w(ctx, reads_list, *a, **kw):
            rec._group(len(reads_list))
            return batched(ctx, reads_list, *a, **kw)

        def once_w(*a, **kw):
            rec._attempt()
            return once(*a, **kw)

        def run_chains_w(*a, **kw):
            p = rec.parts[-1]
            p["call"] += 1
            p["it"] = 0
            return run_chains(*a, **kw)

        def fwd_w(lemg, beta, lem_pad, slots, *a, **kw):
            out = fwd(lemg, beta, lem_pad, slots, *a, **kw)
            p = rec.parts[-1]
            key = (p["call"], p["it"])
            if key in rec.sweeps and p["local"]:
                r = torch.as_tensor(p["local"], device=slots.device)
                # copies on the device: no wait for the sweep inside the batch
                B = slots.shape[3]
                p["sweep"][key] = {"slots": slots.index_select(3, r),
                                   "h_out": out[2].index_select(2, r),
                                   # state row h * B + b: [G, nl, kept rows, K]
                                   "alphas": torch.stack([out[1].index_select(1, h * B + r)
                                                          for h in range(out[1].shape[1] // B)],
                                                         1),
                                   "it_mode": int(kw.get("it_mode", 2)),
                                   "K_real": int(kw["K_real"])}
            p["it"] += 1
            return out

        def keep_which(which):
            p = rec.parts[-1]
            if p["local"]:
                r = torch.as_tensor(p["local"], device=which.device)
                p["which"][p["call"] + 1] = which.index_select(0, r)

        def lem_subset_w(lem_full, flat_idx, *a, **kw):
            keep_which(flat_idx)
            return lem_subset(lem_full, flat_idx, *a, **kw)

        def gather_words_w(rhb, which):
            keep_which(which)
            return gather_words(rhb, which)

        def gls_w(cache, H, *a, **kw):
            p = rec.parts[-1]
            p["fb_call"] += 1
            p["labels"][p["fb_call"]] = H.detach().clone()
            return gls(cache, H, *a, **kw)

        self._orig = {(_driver, "impute_samples_batched"): batched,
                      (_batch, "_impute_once"): once,
                      (_context, "run_gibbs_chains"): run_chains, (_gibbs, "fwd_sweep"): fwd,
                      (_batch, "lem_subset"): lem_subset, (_batch, "gather_words"): gather_words,
                      (_batch, "gls_from_labels_windowed"): gls}
        _driver.impute_samples_batched = batched_w
        _batch._impute_once = once_w
        _context.run_gibbs_chains = run_chains_w
        _gibbs.fwd_sweep = fwd_w
        _batch.lem_subset = lem_subset_w
        _batch.gather_words = gather_words_w
        _batch.gls_from_labels_windowed = gls_w
        return self

    def uninstall(self) -> None:
        for (mod, name), fn in self._orig.items():
            setattr(mod, name, fn)
        self._orig = {}

    def state(self, K: int) -> Dict:
        """The batch's record on the host, rows in the order of `rows`: per
        Gibbs call the haplotype subsets [rows, Ksub_padded] (panel
        indices); per kept sweep a list over the rows of the slots [G, 4,
        W, ...], drawn labels [G, W] and alphas [G, nl, K] of the row; per
        FB call the labels [B, R] of every chain row of the batch; the
        groups' sizes."""
        at = {r: (p, j) for p in self.parts for j, r in enumerate(p["kept"])}
        calls = sorted({c for p in self.parts for c in p["which"]})
        which = {c: np.stack([at[r][0]["which"][c][at[r][1]].cpu().numpy() % K
                              for r in self.rows]) for c in calls}
        keys = sorted({k for p in self.parts for k in p["sweep"]})
        sweeps = {}
        for k in keys:
            per = [(at[r][0]["sweep"][k], at[r][1]) for r in self.rows]
            first = per[0][0]
            sweeps[k] = {"it_mode": first["it_mode"], "K_real": first["K_real"],
                         "slots": [v["slots"][..., j].cpu().numpy() for v, j in per],
                         "h_out": [v["h_out"][..., j].cpu().numpy() for v, j in per],
                         "alphas": [v["alphas"][:, :, j].cpu().numpy() for v, j in per]}
        labels = {}
        for c in sorted({c for p in self.parts for c in p["labels"]}):
            hs = [(p["start"] * self.C, p["labels"][c]) for p in self.parts]
            B = sum(p["size"] for p in self.parts) * self.C
            H = np.zeros((B, max(h.shape[1] for _, h in hs)), np.int32)
            for r0, h in hs:
                H[r0:r0 + h.shape[0], :h.shape[1]] = h.cpu().numpy()
            labels[c] = H
        return {"which": which, "sweeps": sweeps, "labels": labels, "rows": list(self.rows),
                "C": self.C, "groups": [p["size"] for p in self.parts]}


class SectionEvents:
    """CUDA events and a profiler range at the edges of every timed section
    of the engine (utils/log.py:_Section, active when the configuration
    asks for timings), on a card only. `device_s()` sums each section's device time: from
    the event at its start to the one at its end, so a section's own
    kernels and the gaps between them."""

    def __init__(self):
        self.pending: List[tuple] = []
        self._orig = None

    def install(self) -> "SectionEvents":
        enter, exit_ = _log._Section.__enter__, _log._Section.__exit__
        ev = self

        def enter_w(sec):
            if sec.timers.enabled and torch.cuda.is_available():
                sec._bm_range = torch.profiler.record_function(sec.name)
                sec._bm_range.__enter__()
                sec._bm_e0 = torch.cuda.Event(enable_timing=True)
                sec._bm_e0.record()
            return enter(sec)

        def exit_w(sec, *exc):
            r = exit_(sec, *exc)
            if sec.timers.enabled and torch.cuda.is_available():
                e1 = torch.cuda.Event(enable_timing=True)
                e1.record()
                ev.pending.append((sec.name, sec._bm_e0, e1))
                sec._bm_range.__exit__(None, None, None)
            return r

        self._orig = (enter, exit_)
        _log._Section.__enter__ = enter_w
        _log._Section.__exit__ = exit_w
        return self

    def uninstall(self) -> None:
        if self._orig:
            _log._Section.__enter__, _log._Section.__exit__ = self._orig
            self._orig = None

    def clear(self) -> None:
        self.pending = []

    def device_s(self) -> Dict[str, float]:
        """{section: device seconds}; empty without a card."""
        if not self.pending:
            return {}
        torch.cuda.synchronize()
        out: Dict[str, float] = defaultdict(float)
        for name, e0, e1 in self.pending:
            out[name] += e0.elapsed_time(e1) / 1e3
        return dict(out)
