"""Host-side inputs of the port (NumPy constructors), and the bridge from
a prepared reference to device tensors.

The NumPy constructors compute the same arrays as the JAX package's:
pad_to_multiple (quilt_tpu/kernels/common.py), PaddedReads
(kernels/emissions.py:25-115), GibbsInputs (kernels/gibbs.py:331-397) and
FBInputs.build (kernels/fb_full.py:82-137). PaddedReads.build places every
base by one gather over the flat read arrays where the original copies a
read at a time; the other constructors are copies. FBInputs keeps only what
the bit-matmul FB reads: the packed words, the transitions, the thinned-grid
flags and the sizes; the distinct-haplotype and escape tables of the XLA
body are gone from this path (see quilt_tpu/kernels/fb_pallas.py:11-22).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from .io.reads import SampleReads, bq_to_probs
from .panel.prepare import (
    CompressedPanel, PreparedReference, smoothing_band, trans_rates,
)

# grid padding of the FB inputs; also the FB kernels' checkpoint interval
GRID_CHUNK = 16


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclass
class PaddedReads:
    """Dense padded read tensors.

    u_pad[r, j] is the SNP index of base j of read r (0 for pads);
    lr/la are log-emission factors for hap-allele 0 / 1:
      lr = log(pR*(1-ref_error) + pA*ref_error)
      la = log(pA*(1-ref_error) + pR*ref_error)
    so log P(base | allele a) = lr + a*(la-lr). Pads have lr = la = 0.
    lpr/lpa are log pR / log pA (0 for pads and bq == 0 bases).
    """

    u_pad: np.ndarray       # int32 [R, J]
    lr: np.ndarray          # float32 [R, J]
    la: np.ndarray          # float32 [R, J]
    mask: np.ndarray        # bool [R, J]
    wif0: np.ndarray        # int32 [R]
    nReads: int
    J: int
    lpr: np.ndarray = None  # float32 [R, J]
    lpa: np.ndarray = None  # float32 [R, J]

    @classmethod
    def build_batched(cls, reads_list, ref_error: float = 0.001,
                      Jmax: int = 10000, R_pad_to: int = 64) -> "PaddedReads":
        """Stack several samples' reads into [B, R, J] arrays (rows align
        with GibbsInputs.build_batched)."""
        built = [cls.build(r, ref_error, Jmax) for r in reads_list]
        R = pad_to_multiple(max(b.nReads for b in built), R_pad_to)
        J = max(b.J for b in built)
        n = len(built)
        u = np.zeros((n, R, J), dtype=np.int32)
        lr = np.zeros((n, R, J), dtype=np.float32)
        la = np.zeros((n, R, J), dtype=np.float32)
        lpr = np.zeros((n, R, J), dtype=np.float32)
        lpa = np.zeros((n, R, J), dtype=np.float32)
        mask = np.zeros((n, R, J), dtype=bool)
        wif0 = np.zeros((n, R), dtype=np.int32)
        for i, b in enumerate(built):
            u[i, : b.nReads, : b.J] = b.u_pad
            lr[i, : b.nReads, : b.J] = b.lr
            la[i, : b.nReads, : b.J] = b.la
            lpr[i, : b.nReads, : b.J] = b.lpr
            lpa[i, : b.nReads, : b.J] = b.lpa
            mask[i, : b.nReads, : b.J] = b.mask
            wif0[i, : b.nReads] = b.wif0
        return cls(u_pad=u, lr=lr, la=la, mask=mask, wif0=wif0,
                   nReads=R, J=J, lpr=lpr, lpa=lpa)

    @classmethod
    def build(cls, reads: SampleReads, ref_error: float = 0.001,
              Jmax: int = 10000) -> "PaddedReads":
        nReads = reads.nReads
        lens = np.minimum(np.diff(reads.offsets), Jmax + 1).astype(np.int64)
        J = max(int(lens.max()) if nReads else 1, 1)
        u_pad = np.zeros((nReads, J), dtype=np.int32)
        lr = np.zeros((nReads, J), dtype=np.float32)
        la = np.zeros((nReads, J), dtype=np.float32)
        lpr = np.zeros((nReads, J), dtype=np.float32)
        lpa = np.zeros((nReads, J), dtype=np.float32)
        mask = np.zeros((nReads, J), dtype=bool)
        probs = bq_to_probs(reads.bq)
        t_ref = probs[:, 0] * (1 - ref_error) + probs[:, 1] * ref_error
        t_alt = probs[:, 1] * (1 - ref_error) + probs[:, 0] * ref_error
        log_tr = np.log(t_ref)
        log_ta = np.log(t_alt)
        log_pr = np.log(np.maximum(probs[:, 0], 1e-30))
        log_pa = np.log(np.maximum(probs[:, 1], 1e-30))
        # bases with bq == 0 are skipped in GL building (reference:
        # impute_using_everything, functions.R:2018-2020)
        zero = reads.bq == 0
        log_pr = np.where(zero, 0.0, log_pr)
        log_pa = np.where(zero, 0.0, log_pa)
        # each kept base (the first lens[r] of read r): its row and column,
        # its place in the [nReads, J] arrays and in the flat read arrays
        row = np.repeat(np.arange(nReads), lens)
        col = np.arange(len(row)) - np.repeat(np.cumsum(lens) - lens, lens)
        at = row * J + col
        src = reads.offsets[row] + col
        u_pad.reshape(-1)[at] = reads.u[src]
        lr.reshape(-1)[at] = log_tr[src]
        la.reshape(-1)[at] = log_ta[src]
        lpr.reshape(-1)[at] = log_pr[src]
        lpa.reshape(-1)[at] = log_pa[src]
        mask.reshape(-1)[at] = True
        return cls(u_pad=u_pad, lr=lr, la=la, mask=mask,
                   wif0=reads.wif0.astype(np.int32), nReads=nReads, J=J,
                   lpr=lpr, lpa=lpa)


@dataclass
class GibbsInputs:
    """Read structures of the Gibbs sweep, per batch row ([n_rows, ...])."""

    wif0: np.ndarray         # int32 [n_rows, R]
    read_start: np.ndarray   # int32 [n_rows, G]
    read_count: np.ndarray   # int32 [n_rows, G]
    read_mask: np.ndarray    # bool [n_rows, R]
    trans: np.ndarray        # f32 [G, 2] transition INTO grid g (row 0 = (1,0))
    G: int
    R: int

    @classmethod
    def build_batched(cls, reads_list, trans: np.ndarray, nGrids: int,
                      R_pad_to: int = 64) -> "GibbsInputs":
        n = len(reads_list)
        Rp = pad_to_multiple(max(max(r.nReads for r in reads_list), 1), R_pad_to)
        wif0 = np.full((n, Rp), nGrids - 1, dtype=np.int32)
        mask = np.zeros((n, Rp), dtype=bool)
        read_start = np.zeros((n, nGrids), dtype=np.int32)
        read_count = np.zeros((n, nGrids), dtype=np.int32)
        for i, reads in enumerate(reads_list):
            w = reads.wif0.astype(np.int32)
            if (np.diff(w) < 0).any():
                raise ValueError("reads must be sorted by grid")
            R = reads.nReads
            wif0[i, :R] = w
            mask[i, :R] = True
            read_start[i] = np.searchsorted(w, np.arange(nGrids), side="left")
            read_count[i] = (np.searchsorted(w, np.arange(nGrids), side="right")
                             - read_start[i])
        return cls(wif0=wif0, read_start=read_start, read_count=read_count,
                   read_mask=mask, trans=gibbs_trans(trans, nGrids),
                   G=nGrids, R=Rp)

    def repeat_rows(self, n_chains: int) -> "GibbsInputs":
        """Each sample row repeated n_chains times (chain batching)."""
        return GibbsInputs(
            wif0=np.repeat(self.wif0, n_chains, axis=0),
            read_start=np.repeat(self.read_start, n_chains, axis=0),
            read_count=np.repeat(self.read_count, n_chains, axis=0),
            read_mask=np.repeat(self.read_mask, n_chains, axis=0),
            trans=self.trans, G=self.G, R=self.R,
        )


def gibbs_trans(trans: np.ndarray, nGrids: int) -> np.ndarray:
    """[nGrids, 2] (stay, jump) into each grid from the [2, nGrids-1] gap
    rates; grid 0 gets (1, 0)."""
    out = np.zeros((nGrids, 2), dtype=np.float32)
    out[0] = (1.0, 0.0)
    out[1:] = np.asarray(trans, dtype=np.float32).T
    return out


FB_FIELDS = ("words", "trans", "thin_flag", "K", "K_pad", "nGrids", "S", "nSNPs",
             "capture_grid")


@dataclass
class FBInputs:
    """Static per-region inputs of the full-panel FB."""

    words: np.ndarray         # int32 [Gp, K_pad] packed panel bits
    trans: np.ndarray         # f32 [Gp, 2]; row g = (stay, jump) INTO g
    thin_flag: np.ndarray     # int32 [Gp]; slot index at thinned grids else -1
    K: int
    K_pad: int
    nGrids: int               # Gp: grids padded to GRID_CHUNK
    S: int                    # Gp * 32
    nSNPs: int
    capture_grid: int = -1    # grid whose gamma the FB captures (hla_run), -1 none
    _dev: Dict = field(default_factory=dict, init=False, repr=False)

    @classmethod
    def build(cls, panel: CompressedPanel, trans: np.ndarray,
              thinned_grids: Optional[np.ndarray] = None,
              capture_grid: int = -1) -> "FBInputs":
        K, nGrids = panel.K, panel.nGrids
        # a multiple of 128 is also a multiple of every K split the tiled FB
        # takes (1, 2, 4 or 8 blocks per row), so the split needs no padding
        # of its own (the JAX package's K_TILE = 4096 was a VMEM size)
        K_pad = pad_to_multiple(K, 128)
        # grid axis padded with NEUTRAL grids (stay=1/jump=0, all-zero
        # words): the recursion passes through them unchanged
        Gp = pad_to_multiple(nGrids, GRID_CHUNK)
        trans_full = np.zeros((Gp, 2), dtype=np.float32)
        trans_full[0] = (1.0, 1.0)    # g=0: alpha carry 0 => prior jump/K
        trans_full[1:nGrids] = np.asarray(trans, dtype=np.float32).T
        trans_full[nGrids:] = (1.0, 0.0)
        thin_flag = np.full(Gp, -1, dtype=np.int32)
        if thinned_grids is not None:
            for i, g in enumerate(thinned_grids):
                thin_flag[int(g)] = i
        # exact reconstruction of the packed panel from the compressed one
        # (distinct-hap words + escapes)
        dhm = panel.hapMatcher.astype(np.int32)               # [K, nGrids]
        w = panel.distinctHapsB[np.maximum(dhm - 1, 0), np.arange(nGrids)[None, :]]
        w = np.where(dhm > 0, w, np.uint32(0))
        if len(panel.esc_k):
            w[panel.esc_k, panel.esc_grid] = panel.esc_word
        words = np.zeros((Gp, K_pad), dtype=np.uint32)
        words[:nGrids, :K] = w.T
        return cls(words=words.view(np.int32), trans=trans_full,
                   thin_flag=thin_flag, K=K, K_pad=K_pad, nGrids=Gp,
                   S=Gp * 32, nSNPs=panel.nSNPs, capture_grid=capture_grid)

    def device_tensors(self, device) -> Dict[str, Optional[torch.Tensor]]:
        """words / trans2 [2, Gp] / thin_flag on `device`, uploaded once, and
        capture_flag [Gp] f32, 1 at the capture grid (None without one;
        quilt_tpu/kernels/fb_full.py:FBInputs.device)."""
        key = (str(torch.device(device)), self.capture_grid)
        if key not in self._dev:
            cap = None
            if self.capture_grid >= 0:
                cap = torch.zeros(self.nGrids, dtype=torch.float32, device=device)
                cap[self.capture_grid] = 1.0
            self._dev[key] = {
                "words": torch.as_tensor(self.words, device=device).contiguous(),
                "trans2": torch.as_tensor(self.trans.T.copy(), device=device),
                "thin_flag": torch.as_tensor(self.thin_flag, device=device),
                "capture_flag": cap,
            }
        return self._dev[key]


def fb_inputs_from_reference(fields: Dict) -> FBInputs:
    """The port's FBInputs from the JAX package's FBInputs fields, given as
    {name: numpy array or int} for the names in FB_FIELDS (so both
    packages compute on identical arrays)."""
    return FBInputs(
        words=np.ascontiguousarray(fields["words"]).view(np.int32),
        trans=np.asarray(fields["trans"], dtype=np.float32),
        thin_flag=np.asarray(fields["thin_flag"], dtype=np.int32),
        K=int(fields["K"]), K_pad=int(fields["K_pad"]),
        nGrids=int(fields["nGrids"]), S=int(fields["S"]),
        nSNPs=int(fields["nSNPs"]), capture_grid=int(fields.get("capture_grid", -1)),
    )


def thinned_grids(nGrids: int, heuristic_match_thin: float) -> np.ndarray:
    """Grids whose top-K gamma lists feed the haplotype re-selection."""
    n_thin = max(1, round(heuristic_match_thin * nGrids))
    return np.unique(np.linspace(0, nGrids - 1, n_thin).round().astype(np.int64))


def capture_grid(prep: PreparedReference, cfg) -> int:
    """The grid whose full-panel gamma an HLA run captures: the grid of the
    SNP physically closest to cfg.gamma_physically_closest_to, else the
    middle grid (quilt_tpu/engine/sample.py:129-145); -1 without hla_run."""
    if not cfg.hla_run:
        return -1
    if cfg.gamma_physically_closest_to is not None:
        return int(prep.grid[int(np.abs(prep.pos - cfg.gamma_physically_closest_to).argmin())])
    return prep.nGrids // 2


def region_tensors(prep: PreparedReference, cfg, device) -> Dict:
    """Carry a prepared reference's state to the port's device tensors.

    Returns a dict with the host objects "trans" ([2, nGrids-1] gap rates),
    "thinned_grids", "fb" (FBInputs) and "smooth_w" (the bp-smoothing band
    of on-the-fly block boundaries, or None), and the tensors on `device`:
    "rhb_t" [K, nGrids] i32 packed panel, "words" / "trans2" / "thin_flag"
    of the FB, "gibbs_trans" [2, nGrids] f32 of the Gibbs sweeps, and
    "smooth_band" / "smooth_idx0" (None without block boundaries). Under
    msPBWT selection nothing runs the full-panel FB: "fb" and
    "thinned_grids" are None and the FB tensors are not uploaded, unless
    the run is an HLA run, whose FB inputs carry the capture grid."""
    trans = trans_rates(prep.sigma)
    smooth_w = None
    if (cfg.block_gibbs_boundary_detection == "gamma" and prep.nGrids > 4
            and cfg.max_block_gibbs_boundaries > 0):
        smooth_w = smoothing_band(prep.L_grid, cfg.shuffle_bin_radius)
    out = {"trans": trans, "thinned_grids": None, "fb": None, "smooth_w": smooth_w}
    if not cfg.use_mspbwt or cfg.hla_run:
        out["thinned_grids"] = thinned_grids(prep.nGrids, cfg.heuristic_match_thin)
        out["fb"] = FBInputs.build(prep.panel, trans, thinned_grids=out["thinned_grids"],
                                   capture_grid=capture_grid(prep, cfg))
        out.update(out["fb"].device_tensors(device))
    out["rhb_t"] = torch.as_tensor(
        np.ascontiguousarray(prep.rhb_t).view(np.int32), device=device
    )
    out["gibbs_trans"] = torch.as_tensor(
        np.ascontiguousarray(gibbs_trans(trans, prep.nGrids).T), device=device
    )
    out["smooth_band"] = out["smooth_idx0"] = None
    if smooth_w is not None:
        out["smooth_band"] = torch.as_tensor(smooth_w[0], device=device)
        out["smooth_idx0"] = torch.as_tensor(
            np.asarray(smooth_w[1], dtype=np.int64), device=device
        )
    return out
