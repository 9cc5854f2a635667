"""Per-sample diagnostic plots and data export.

Light-weight equivalent of the reference's plot suite
(QUILT/R/plotting_functions.R:1-1014: gamma/dosage vs truth :67-321,
per-iteration likelihood traces :351-552): a dosage/GP panel figure per
sample plus a machine-readable export of the same data, gated behind
make_plots / plot_per_sample_likelihoods.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..utils import print_message


def plot_sample_diagnostics(
    outdir: str,
    sample_name: str,
    region_name: str,
    pos: np.ndarray,
    dosage: np.ndarray,
    gp: np.ndarray,
    af: Optional[np.ndarray] = None,
    truth_gen: Optional[np.ndarray] = None,
    per_it_likelihoods: Optional[np.ndarray] = None,
    export_data: bool = True,
) -> Optional[str]:
    os.makedirs(os.path.join(outdir, "plots"), exist_ok=True)
    base = os.path.join(
        outdir, "plots", f"haps.{sample_name}.{region_name}"
    )
    if export_data:
        cols = {"pos": pos, "dosage": dosage,
                "gp0": gp[0], "gp1": gp[1], "gp2": gp[2]}
        if af is not None:
            cols["af"] = af
        if truth_gen is not None:
            cols["truth"] = truth_gen
        arr = np.column_stack(list(cols.values()))
        np.savetxt(
            base + ".diagnostics.tsv.gz", arr, delimiter="\t",
            header="\t".join(cols), comments="",
        )
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    n_rows = 2 + (per_it_likelihoods is not None)
    fig, axes = plt.subplots(
        n_rows, 1, figsize=(14, 3 * n_rows), sharex=False
    )
    ax = axes[0]
    ax.plot(pos, dosage, ".", ms=2, color="tab:blue", label="imputed dosage")
    if truth_gen is not None:
        ok = np.isfinite(truth_gen)
        ax.plot(pos[ok], truth_gen[ok], ".", ms=2, color="tab:red",
                alpha=0.5, label="truth")
    ax.set_ylabel("dosage")
    ax.set_title(f"{sample_name} {region_name}")
    ax.legend(loc="upper right", fontsize=8)
    ax = axes[1]
    maxgp = gp.max(axis=0)
    ax.plot(pos, maxgp, ".", ms=2, color="tab:green")
    ax.set_ylabel("max GP")
    ax.set_xlabel("position")
    if per_it_likelihoods is not None:
        ax = axes[2]
        ll = np.asarray(per_it_likelihoods)
        # column 3 = p_O_given_H_L when the full kernels.gibbs.PER_IT_COLS
        # matrix is passed; 2-column inputs keep column 0
        col = 3 if ll.shape[2] > 3 else 0
        for b in range(ll.shape[1]):
            ax.plot(ll[:, b, col], alpha=0.6)
        ax.set_ylabel("log P(O|H)")
        ax.set_xlabel("Gibbs iteration")
    fig.tight_layout()
    out = base + ".png"
    fig.savefig(out, dpi=110)
    plt.close(fig)
    print_message(f"Wrote {out}")
    return out


def plot_heuristic_comparison(
    outdir: str,
    sample_name: str,
    region_name: str,
    traces: "dict[str, np.ndarray]",   # strategy label -> r2 per seek it
    export_data: bool = True,
) -> Optional[str]:
    """Hap-selection strategy comparison: dosage r2 vs truth per seek
    iteration for each strategy (functional equivalent of the reference's
    make_heuristic_plot, QUILT/R/heuristic.R:40-176)."""
    os.makedirs(os.path.join(outdir, "plots"), exist_ok=True)
    base = os.path.join(
        outdir, "plots", f"heuristic.{sample_name}.{region_name}"
    )
    if export_data:
        with open(base + ".tsv", "w") as fh:
            fh.write("strategy\tseek_it\tr2\n")
            for label, r2s in traces.items():
                for i, r2 in enumerate(r2s):
                    fh.write(f"{label}\t{i + 1}\t{r2:.6f}\n")
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for label, r2s in traces.items():
        ax.plot(range(1, len(r2s) + 1), r2s, marker="o", label=label)
    ax.set_xlabel("seek iteration")
    ax.set_ylabel("dosage r2 vs truth")
    ax.set_title(f"hap selection strategies: {sample_name} {region_name}")
    ax.legend()
    fig.tight_layout()
    out = base + ".png"
    fig.savefig(out, dpi=110)
    plt.close(fig)
    print_message(f"Wrote {out}")
    return out


def plot_read_label_flips(
    outdir: str,
    sample_name: str,
    region_name: str,
    read_label_usage: np.ndarray,     # int [n_seek_its, C, R]
    export_data: bool = True,
) -> Optional[str]:
    """Read-label stability diagnostics: per-read label heatmap over
    (seek iteration x chain) plus the per-read cross-chain flip fraction.

    Functional equivalent of the reference's
    plot_prob_of_flipping_to_first_hap (plotting_functions.R:553-637): the
    reference rasterizes per-sampling-iteration flip probabilities; here
    the recorded end-of-seek-iteration labels per chain play that role
    (record_read_label_usage)."""
    os.makedirs(os.path.join(outdir, "plots"), exist_ok=True)
    base = os.path.join(
        outdir, "plots", f"readflips.{sample_name}.{region_name}"
    )
    lab = np.asarray(read_label_usage)
    n_its, C, R = lab.shape
    # fraction of chains disagreeing with the majority label, per read/it
    flip = np.empty((n_its, R))
    for t in range(n_its):
        if lab.max() <= 1:
            maj = (lab[t].mean(axis=0) >= 0.5).astype(lab.dtype)
        else:
            # NIPT labels 0..2: modal label per read
            maj = np.array([
                np.bincount(lab[t, :, r]).argmax() for r in range(R)
            ], dtype=lab.dtype)
        flip[t] = (lab[t] != maj[None, :]).mean(axis=0)
    if export_data:
        np.savez_compressed(
            base + ".npz", read_label_usage=lab, flip_fraction=flip
        )
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    fig, axes = plt.subplots(2, 1, figsize=(12, 7))
    ax = axes[0]
    im = ax.imshow(
        lab.reshape(n_its * C, R), aspect="auto", interpolation="nearest",
        cmap="coolwarm",
    )
    ax.set_yticks(np.arange(0, n_its * C, C))
    ax.set_yticklabels([f"it {t + 1}" for t in range(n_its)])
    ax.set_xlabel("read")
    ax.set_title(
        f"read labels per (seek it x chain): {sample_name} {region_name}"
    )
    fig.colorbar(im, ax=ax, shrink=0.8, label="label")
    ax = axes[1]
    for t in range(n_its):
        ax.plot(flip[t], alpha=0.7, label=f"it {t + 1}")
    ax.set_xlabel("read")
    ax.set_ylabel("cross-chain flip fraction")
    ax.legend(fontsize=8)
    fig.tight_layout()
    out = base + ".png"
    fig.savefig(out, dpi=110)
    plt.close(fig)
    print_message(f"Wrote {out}")
    return out


def plot_hclass(
    outdir: str,
    sample_name: str,
    region_name: str,
    H_class: np.ndarray,              # int [C, R] final NIPT H_class
    export_data: bool = True,
) -> Optional[str]:
    """NIPT H_class diagnostics: per-chain read class assignment (1..6
    permutation classes; reference plots H_class trajectories in its
    block-Gibbs diagnostics, plotting_functions.R:638-734)."""
    os.makedirs(os.path.join(outdir, "plots"), exist_ok=True)
    base = os.path.join(
        outdir, "plots", f"hclass.{sample_name}.{region_name}"
    )
    H = np.asarray(H_class)
    if export_data:
        np.savez_compressed(base + ".npz", H_class=H)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    C, R = H.shape
    fig, axes = plt.subplots(2, 1, figsize=(12, 6))
    ax = axes[0]
    im = ax.imshow(H, aspect="auto", interpolation="nearest", cmap="viridis")
    ax.set_ylabel("chain")
    ax.set_xlabel("read")
    ax.set_title(f"NIPT H_class: {sample_name} {region_name}")
    fig.colorbar(im, ax=ax, shrink=0.8, label="H_class")
    ax = axes[1]
    vals, counts = np.unique(H, return_counts=True)
    ax.bar(vals, counts, color="tab:blue")
    ax.set_xlabel("H_class")
    ax.set_ylabel("#reads x chains")
    fig.tight_layout()
    out = base + ".png"
    fig.savefig(out, dpi=110)
    plt.close(fig)
    print_message(f"Wrote {out}")
    return out


def plot_block_gibbs(
    outdir: str,
    sample_name: str,
    region_name: str,
    L_grid: np.ndarray,               # [nGrids] grid physical positions
    smooth_rate: np.ndarray,          # [nGrids-1] smoothed recomb rate
    boundaries: np.ndarray,           # block-Gibbs boundary grid indices
    quantile_prob: float = 0.9,
    read_label_usage: Optional[np.ndarray] = None,  # [n_its, C, R]
    read_grids: Optional[np.ndarray] = None,        # [R] wif0 per read
    export_data: bool = True,
) -> Optional[str]:
    """Block-Gibbs diagnostics: the block-defining smoothed recombination
    rate with its quantile threshold and chosen boundaries, plus read
    labels around the blocks.

    Light equivalent of the reference's plot_attempt_to_reblock_snps
    (QUILT/R/gibbs-nipt-block.R:2006-2315), which draws the blocked SNPs,
    break threshold/smoothed rate, and before/after read labels; here the
    recorded per-seek-iteration labels (record_read_label_usage) play the
    before/after role."""
    os.makedirs(os.path.join(outdir, "plots"), exist_ok=True)
    base = os.path.join(
        outdir, "plots", f"blockgibbs.{sample_name}.{region_name}"
    )
    L_grid = np.asarray(L_grid)
    smooth_rate = np.asarray(smooth_rate)
    boundaries = np.asarray(boundaries, dtype=int)
    thresh = (
        np.quantile(smooth_rate, quantile_prob) if len(smooth_rate) else 0.0
    )
    if export_data:
        data = {
            "L_grid": L_grid, "smooth_rate": smooth_rate,
            "boundaries": boundaries, "break_thresh": np.array(thresh),
        }
        if read_label_usage is not None:
            data["read_label_usage"] = read_label_usage
        if read_grids is not None:
            data["read_grids"] = read_grids
        np.savez_compressed(base + ".npz", **data)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    n_rows = 2 if read_label_usage is not None else 1
    fig, axes = plt.subplots(
        n_rows, 1, figsize=(12, 4 * n_rows), squeeze=False
    )
    ax = axes[0, 0]
    mid = 0.5 * (L_grid[:-1] + L_grid[1:])
    ax.plot(mid, smooth_rate, lw=1, label="smoothed rate")
    ax.axhline(thresh, color="red", ls="--", lw=1,
               label=f"{quantile_prob:.0%} quantile")
    for b in boundaries:
        if 0 < b < len(L_grid):
            ax.axvline(L_grid[b], color="grey", ls=":", lw=1)
    ax.set_xlabel("position (bp)")
    ax.set_ylabel("recombination rate")
    ax.set_title(
        f"block-Gibbs blocks: {sample_name} {region_name} "
        f"({len(boundaries)} boundaries)"
    )
    ax.legend(fontsize=8)
    if read_label_usage is not None and read_grids is not None:
        ax = axes[1, 0]
        lab = np.asarray(read_label_usage)
        pos_r = L_grid[np.clip(read_grids, 0, len(L_grid) - 1)]
        for t in (0, lab.shape[0] - 1):
            maj = (
                lab[t].mean(axis=0)
                if lab.max() <= 1
                else np.array([
                    np.bincount(lab[t, :, r]).argmax()
                    for r in range(lab.shape[2])
                ])
            )
            ax.scatter(
                pos_r, maj + (0.05 if t else -0.05), s=4, alpha=0.5,
                label=f"seek it {t + 1}",
            )
        for b in boundaries:
            if 0 < b < len(L_grid):
                ax.axvline(L_grid[b], color="grey", ls=":", lw=1)
        ax.set_xlabel("position (bp)")
        ax.set_ylabel("read label (majority)")
        ax.legend(fontsize=8)
    fig.tight_layout()
    out = base + ".png"
    fig.savefig(out, dpi=110)
    plt.close(fig)
    print_message(f"Wrote {out}")
    return out
