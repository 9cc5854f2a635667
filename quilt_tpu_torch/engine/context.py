"""Per-region state of the port's engine, and NumPy copies of the host
helpers of the JAX package's engine.

RegionContext is the counterpart of
quilt_tpu/engine/sample.py:RegionContext (:40-216), with the QUILT2 state
of :100-151 (the distinct-haplotype bits of msPBWT selection, the all-SNP
transitions and panel of rare/common imputation), the HLA run's gamma
capture (:129-145, the capture grid in inputs.capture_grid), the static
map boundaries of :152-157 and the device mesh of :189-215 (with the
panel-sharded FB when the panel axis is split); detect_boundaries is
quilt_tpu/oracle/block_gibbs.py:36, sample_allele_count
quilt_tpu/engine/sample.py:716, and the validators
quilt_tpu/engine/validators.py:15,79.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import ImputeConfig
from ..io.reads import SampleReads, bq_to_probs
from ..panel.prepare import PreparedReference, make_smoothed_rate, trans_rates
from ..utils import print_message
from ..utils.log import SectionTimers

from ..dist.mesh import (
    ShardedFB, as_device, default_devices, mesh_from_config, shard_gibbs_batch,
)
from ..inputs import FBInputs, gibbs_trans, region_tensors, thinned_grids
from ..kernels.emissions import expand_panel
from ..kernels.gibbs import run_gibbs_chains
from ..panel.mspbwt import distinct_hap_bits
from .rare_common import all_snp_panel


@dataclass
class RegionContext:
    """Per-region constants and device tensors shared across sample
    batches (on `device`; n_latent = 2 diploid, 3 NIPT). Under msPBWT
    selection the FB inputs are not built up front (fb_inputs and
    thinned_grids are None until fb_state() builds them) and the distinct
    haplotypes [nMaxDH, nGrids*32] (dh_bits()) are; a run of the other
    mode on the same context (the heuristic comparison) builds what it
    needs on first use. Under rare/common, trans_all / nGrids_all are the
    all-SNP grid's and tensors["rhb_all"] [K, nGrids_all] i32 /
    tensors["gibbs_trans_all"] [2, nGrids_all] its packed panel and Gibbs
    transitions. boundaries [NB] are the static map's block-Gibbs suffix
    starts (None at 4 grids or fewer), built in every mode (the block
    Gibbs plot reads them); the Gibbs calls take them when smooth_w, the
    on-the-fly detector's band, is None. With mesh_data x mesh_panel > 1,
    mesh is the [n_data, n_panel] device mesh over `devices` (the Gibbs
    calls split their chains over it) and, when the panel axis is split
    and the FB inputs exist, sharded_fb the panel-sharded FB."""

    prep: PreparedReference
    device: torch.device
    trans: np.ndarray              # [2, nGrids-1] (stay, jump) per gap
    fb_inputs: Optional[FBInputs]
    thinned_grids: Optional[np.ndarray]
    Ksub: int
    Knew: int
    n_seek_its: int
    n_burn_in_seek_its: int
    tensors: Dict                  # inputs.region_tensors: rhb_t, words, ...
    smooth_w: Optional[tuple]      # on-the-fly boundary band (band, idx0) tensors
    boundaries: Optional[np.ndarray]   # [NB] static map suffix starts (b >= 1)
    smooth_cm: np.ndarray          # [nGrids-1] smoothed recombination rate
    heuristic_match_thin: float
    block_quantile: float
    block_nb_cap: int
    timers: SectionTimers
    trans_all: Optional[np.ndarray] = None   # [2, nGrids_all-1] all-SNP gap rates
    nGrids_all: int = 0
    n_latent: int = 2
    # family / splits forced on kernels.fb.fb_plan (empty: its own rule)
    fb_plan_args: Dict = field(default_factory=dict)
    # HLA run: the FB captures gamma at fb_inputs.capture_grid
    hla_capture: bool = False
    devices: Optional[tuple] = None       # the devices the mesh was made from
    mesh: Optional[np.ndarray] = None     # [n_data, n_panel] torch devices
    sharded_fb: Optional[ShardedFB] = None
    _e_full: Optional[torch.Tensor] = None
    _boundaries_dev: Optional[torch.Tensor] = None

    def rhb_dev(self) -> torch.Tensor:
        """Packed panel [K, nGrids] i32 on the device."""
        return self.tensors["rhb_t"]

    def e_full_dev(self) -> torch.Tensor:
        """{0,1} float32 expansion of the whole panel [K, nGrids*32],
        built on first use (operand of the per-batch eMatRead products)."""
        if self._e_full is None:
            self._e_full = expand_panel(self.rhb_dev())
        return self._e_full

    def dh_bits(self) -> torch.Tensor:
        """Distinct haplotypes [nMaxDH, nGrids*32] of the msPBWT symbols,
        built on first use."""
        if "dh_bits" not in self.tensors:
            self.tensors["dh_bits"] = distinct_hap_bits(self.prep.panel, self.device)
        return self.tensors["dh_bits"]

    def fb_state(self):
        """(FBInputs, thinned grids) of the full-panel FB, built on first
        use when the context was made for msPBWT selection."""
        if self.fb_inputs is None:
            self.thinned_grids = thinned_grids(self.prep.nGrids, self.heuristic_match_thin)
            self.fb_inputs = FBInputs.build(self.prep.panel, self.trans,
                                            thinned_grids=self.thinned_grids)
        return self.fb_inputs, self.thinned_grids

    def gibbs_call(self):
        """kernels.gibbs.run_gibbs_chains, with the chains split over the
        mesh when there is one (dist.mesh.shard_gibbs_batch)."""
        if self.mesh is None:
            return run_gibbs_chains
        return functools.partial(shard_gibbs_batch, self.mesh)

    def boundaries_dev(self) -> Optional[torch.Tensor]:
        """The static boundaries as an int32 device tensor [NB] when the
        Gibbs calls take them (no on-the-fly band), else None."""
        if self.smooth_w is not None or self.boundaries is None:
            return None
        if self._boundaries_dev is None:
            self._boundaries_dev = torch.as_tensor(
                self.boundaries.astype(np.int32), device=self.device)
        return self._boundaries_dev

    def block_slots(self) -> int:
        """Block-move slots of a Gibbs call: the on-the-fly cap, or the
        number of static boundaries."""
        if self.smooth_w is not None:
            return self.block_nb_cap
        return 0 if self.boundaries is None else len(self.boundaries)

    @classmethod
    def build(cls, prep: PreparedReference, cfg: ImputeConfig, device,
              devices: Optional[Sequence] = None) -> "RegionContext":
        """The context on `device`; the mesh (if the config asks for one) is
        made from `devices`, by default the visible cards from `device` on
        (dist.mesh.default_devices); too few raise ValueError."""
        K = prep.K
        Ksub = min(cfg.Ksubset, K)
        Knew = min(cfg.Knew, Ksub)
        n_seek = cfg.n_seek_its
        n_burn = cfg.resolved_n_burn_in_seek_its()
        if cfg.override_default_params_for_small_ref_panel and K <= cfg.Ksubset:
            # small-panel override (reference: quilt.R:451-465)
            n_seek, n_burn, Ksub, Knew = 1, 0, K, K
        t = region_tensors(prep, cfg, device)
        smooth = make_smoothed_rate(prep.sigma, prep.L_grid, cfg.shuffle_bin_radius)
        boundaries = detect_boundaries(smooth, 0.9) if prep.nGrids > 4 else None
        nb_cap = cfg.max_block_gibbs_boundaries
        if t["smooth_w"] is not None and len(smooth) > 1:
            # the reference's detector is uncapped; raise the slot count to
            # the static map's run estimate (2 boundaries per run)
            above = smooth >= np.quantile(smooth, cfg.block_gibbs_quantile_prob)
            n_runs = int((above & ~np.concatenate([[False], above[:-1]])).sum())
            raised = max(nb_cap, min(2 * n_runs, 128))
            if raised > nb_cap:
                print_message(
                    f"Raising max_block_gibbs_boundaries {nb_cap} -> {raised} "
                    f"(static map suggests ~{2 * n_runs} above-quantile boundaries)"
                )
                nb_cap = raised
        smooth_w = None
        if t["smooth_band"] is not None:
            smooth_w = (t["smooth_band"], t["smooth_idx0"])
        trans_all, nGrids_all = None, 0
        if cfg.impute_rare_common and prep.snp_is_common is not None:
            trans_all = trans_rates(prep.sigma_all)
            nGrids_all = len(prep.L_grid_all)
            t["rhb_all"] = torch.as_tensor(all_snp_panel(
                prep.rhb_t, prep.snp_is_common, prep.rare_per_hap_info, nGrids_all,
            ), device=device)
            t["gibbs_trans_all"] = torch.as_tensor(
                np.ascontiguousarray(gibbs_trans(trans_all, nGrids_all).T), device=device)
        devices = tuple(as_device(d) for d in (default_devices(device) if devices is None
                                               else devices))
        mesh = mesh_from_config(cfg, devices)
        sharded_fb = None
        if mesh is not None and mesh.shape[1] > 1 and t["fb"] is not None:
            print_message(f"Panel-sharded FB over mesh data={mesh.shape[0]} x "
                          f"panel={mesh.shape[1]}")
            sharded_fb = ShardedFB(t["fb"], mesh, K_top=max(8, cfg.K_top_matches),
                                   ref_error=prep.ref_error)
        ctx = cls(
            prep=prep, device=torch.device(device), trans=t["trans"],
            fb_inputs=t["fb"], thinned_grids=t["thinned_grids"], Ksub=Ksub,
            Knew=Knew, n_seek_its=n_seek, n_burn_in_seek_its=n_burn, tensors=t,
            smooth_w=smooth_w, boundaries=boundaries, smooth_cm=smooth,
            heuristic_match_thin=cfg.heuristic_match_thin,
            block_quantile=cfg.block_gibbs_quantile_prob,
            block_nb_cap=nb_cap,
            timers=SectionTimers(cfg.print_extra_timing_information, device),
            trans_all=trans_all, nGrids_all=nGrids_all,
            n_latent=3 if cfg.method == "nipt" else 2,
            hla_capture=t["fb"] is not None and t["fb"].capture_grid >= 0,
            devices=devices, mesh=mesh, sharded_fb=sharded_fb,
        )
        if cfg.use_mspbwt:
            ctx.dh_bits()
        return ctx


class _FieldRecorder:
    """Stands in for a config while RegionContext.build runs and records
    every field it reads, including the fields its methods read."""

    def __init__(self, cfg):
        self._cfg = cfg
        self.read = set()

    def __getattr__(self, name):
        attr = getattr(type(self._cfg), name, None)
        if callable(attr):
            return functools.partial(attr, self)
        self.read.add(name)
        return getattr(self._cfg, name)


def context_fields(prep: PreparedReference, cfg: ImputeConfig, device, devices=None):
    """(context, names of the config fields its build read)."""
    rec = _FieldRecorder(cfg)
    ctx = RegionContext.build(prep, rec, device, devices)
    return ctx, frozenset(rec.read)


def detect_boundaries(smooth_rate: np.ndarray, quantile_prob: float = 0.9,
                      max_boundaries: int = 64) -> np.ndarray:
    """Static map boundaries: grids whose incoming smoothed recombination
    rate is above the quantile (suffix starts, b >= 1), the top
    max_boundaries by rate."""
    if len(smooth_rate) == 0:
        return np.zeros(0, dtype=np.int64)
    thresh = np.quantile(smooth_rate, quantile_prob)
    b = np.flatnonzero(smooth_rate >= thresh) + 1
    if len(b) > max_boundaries:
        order = np.argsort(-smooth_rate[b - 1], kind="stable")[:max_boundaries]
        b = np.sort(b[order])
    return b.astype(np.int64)


def sample_allele_count(reads: SampleReads, nSNPs: int) -> np.ndarray:
    """Per-site expected (alt, total) allele counts from the pileup
    (reference: increment2N use at functions.R:1383-1401)."""
    probs = bq_to_probs(reads.bq)
    alt = np.zeros(nSNPs)
    ref = np.zeros(nSNPs)
    np.add.at(alt, reads.u, probs[:, 1])
    np.add.at(ref, reads.u, probs[:, 0])
    return np.stack([alt, ref + alt], axis=1)


class QuiltValidationError(ValueError):
    pass


def validate_impute_config(cfg: ImputeConfig) -> None:
    """Parameter checks of validators.R:1-115 that apply to this path."""
    if cfg.regionStart is not None or cfg.regionEnd is not None:
        if cfg.regionStart is None or cfg.regionEnd is None:
            raise QuiltValidationError("regionStart and regionEnd must be given together")
        if cfg.regionStart >= cfg.regionEnd:
            raise QuiltValidationError(
                f"regionStart ({cfg.regionStart}) must be < regionEnd ({cfg.regionEnd})")
        if cfg.buffer < 0:
            raise QuiltValidationError("buffer must be >= 0")
    if cfg.nGibbsSamples < 1:
        raise QuiltValidationError("nGibbsSamples must be >= 1")
    if cfg.n_seek_its < 1:
        raise QuiltValidationError("n_seek_its must be >= 1")
    n_burn = cfg.resolved_n_burn_in_seek_its()
    if n_burn >= cfg.n_seek_its:
        raise QuiltValidationError(
            f"n_burn_in_seek_its ({n_burn}) must be < n_seek_its ({cfg.n_seek_its})")
    for bit in cfg.small_ref_panel_block_gibbs_iterations:
        if bit < 1:
            raise QuiltValidationError(f"block gibbs iterations must be >= 1 (got {bit})")
    if cfg.Knew > cfg.Ksubset:
        raise QuiltValidationError(f"Knew ({cfg.Knew}) must be <= Ksubset ({cfg.Ksubset})")
    if cfg.method not in ("diploid", "nipt"):
        raise QuiltValidationError(f"unknown method {cfg.method!r}")
    if cfg.maxDifferenceBetweenReads < 1:
        raise QuiltValidationError("maxDifferenceBetweenReads must be >= 1")
    if cfg.heuristic_approach not in ("A", "B"):
        raise QuiltValidationError(
            f"heuristic_approach must be 'A' or 'B' (got {cfg.heuristic_approach!r})")
    if cfg.estimate_bq_using_truth_read_labels:
        raise QuiltValidationError(
            "estimate_bq_using_truth_read_labels is not supported by quilt_tpu")
    if not cfg.use_sample_is_diploid and cfg.method == "diploid":
        # the diploid Gibbs kernel is the two-haplotype instantiation
        # (reference toggles this at functions.R:2539); the flag cannot
        # turn that off
        print_message(
            "Note: use_sample_is_diploid=FALSE has no effect; the diploid "
            "Gibbs kernel always runs the two-haplotype path (documented "
            "deviation, see PARITY.md)")


def validate_region_consistency(prep: PreparedReference, cfg: ImputeConfig) -> None:
    """Prepare/impute region agreement (validators.R:56-80)."""
    if cfg.use_mspbwt and getattr(prep, "ms_indices", None) is None:
        raise QuiltValidationError(
            "use_mspbwt=True but the prepared reference has no mspbwt indices")
    if cfg.regionStart is None:
        return
    if prep.regionStart is None:
        raise QuiltValidationError(
            "prepared reference was built without a region but impute "
            "specifies one; re-run prepare with regionStart/regionEnd")
    if (prep.regionStart != cfg.regionStart or prep.regionEnd != cfg.regionEnd
            or prep.buffer != cfg.buffer):
        raise QuiltValidationError(
            f"region mismatch between prepare ({prep.regionStart}-{prep.regionEnd} "
            f"buffer {prep.buffer}) and impute ({cfg.regionStart}-{cfg.regionEnd} "
            f"buffer {cfg.buffer})")
