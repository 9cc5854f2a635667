"""Genome chunking and phase-aware ligation of per-chunk VCFs.

Equivalents of quilt_chunk_map (reference: QUILT/R/functions.R:3293-3345)
and the recommended bcftools concat --ligate workflow
(README_QUILT2.org:108-125, example/ligation.Md): chunks overlap by a few
sites; at ligation time the phase orientation of each next chunk is chosen
to agree with the previous chunk's phased genotypes over the overlap.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..out.bgzf import BgzfWriter, bgzf_open
from ..utils import print_message


@dataclass
class Chunk:
    chrom: str
    start: int
    end: int

    @property
    def region(self) -> str:
        return f"{self.chrom}:{self.start}-{self.end}"


def quilt_chunk_map(
    chrom: str,
    gmap_pos: np.ndarray,
    gmap_cm: np.ndarray,
    min_bp: int = 3_000_000,
    min_cm: float = 4.0,
    overlap_sites: int = 10,
) -> List[Chunk]:
    """Split a chromosome into chunks >= min_bp and >= min_cm with a
    site overlap for ligation (reference: functions.R:3294-3345)."""
    out: List[Chunk] = []
    start = 1
    max_pos = int(gmap_pos[-1])
    while start < max_pos:
        end = start + min_bp
        w = (gmap_pos >= start) & (gmap_pos <= end)
        while w.sum() == 0 and end < max_pos + min_bp:
            end += min_bp
            w = (gmap_pos >= start) & (gmap_pos <= end)
        while w.sum() > 0 and (gmap_cm[w].max() - gmap_cm[w].min()) < min_cm:
            end += min_bp // 3
            w = (gmap_pos >= start) & (gmap_pos <= end)
            if w.any() and gmap_pos[w][-1] >= max_pos:
                break
        idx = np.flatnonzero(w)
        if len(idx) == 0:
            break
        chunk_end = int(gmap_pos[idx[-1]])
        out.append(Chunk(chrom, start, chunk_end))
        next_idx = idx[max(len(idx) - overlap_sites, 0)]
        new_start = int(gmap_pos[next_idx])
        if new_start <= start:
            break
        start = new_start
        if chunk_end >= max_pos:
            break
    if len(out) >= 2 and out[-1].end - out[-2].end < min_bp // 3:
        out[-2] = Chunk(chrom, out[-2].start, out[-1].end)
        out.pop()
    if out:
        out[0] = Chunk(chrom, 1, out[0].end)
        out[-1] = Chunk(chrom, out[-1].start, out[-1].end + 5_000_000)
    return out


def _parse_vcf(path: str):
    header: List[str] = []
    pos: List[int] = []
    lines: List[List[str]] = []
    for line in bgzf_open(path):
        if line.startswith("#"):
            header.append(line)
        else:
            f = line.rstrip("\n").split("\t")
            pos.append(int(f[1]))
            lines.append(f)
    return header, np.asarray(pos, dtype=np.int64), lines


def _gt_haps(field: str) -> Optional[Tuple[int, ...]]:
    gt = field.split(":", 1)[0]
    if "|" not in gt:
        return None
    try:
        return tuple(int(x) for x in gt.split("|"))
    except ValueError:
        return None


def _swap_gt(field: str) -> str:
    parts = field.split(":")
    gt = parts[0].split("|")
    if len(gt) == 2:
        parts[0] = f"{gt[1]}|{gt[0]}"
    # swap haploid dosages too (FORMAT GT:GP:DS:HD)
    if len(parts) >= 4 and "," in parts[3]:
        hd = parts[3].split(",")
        if len(hd) == 2:
            parts[3] = f"{hd[1]},{hd[0]}"
    return ":".join(parts)


def ligate_vcfs(paths: Sequence[str], out_path: str) -> None:
    """Phase-aware concatenation of overlapping chunk VCFs.

    For each sample, the next chunk's haplotype orientation is flipped if
    the flipped orientation agrees better with the previous chunk's phased
    GT over the overlapping sites (bcftools concat --ligate semantics).
    """
    header0, pos0, lines0 = _parse_vcf(paths[0])
    n_samples = len(lines0[0]) - 9
    out_lines: List[List[str]] = lines0
    out_pos = pos0
    for path in paths[1:]:
        _, pos1, lines1 = _parse_vcf(path)
        overlap = np.intersect1d(out_pos, pos1)
        flip = np.zeros(n_samples, dtype=bool)
        if len(overlap):
            prev_idx = {p: i for i, p in enumerate(out_pos)}
            cur_idx = {p: i for i, p in enumerate(pos1)}
            for s in range(n_samples):
                agree = disagree = 0
                for p in overlap:
                    g_prev = _gt_haps(out_lines[prev_idx[p]][9 + s])
                    g_cur = _gt_haps(lines1[cur_idx[p]][9 + s])
                    if g_prev is None or g_cur is None:
                        continue
                    if len(g_prev) != 2 or sum(g_prev) != 1 or sum(g_cur) != 1:
                        continue
                    if g_prev == g_cur:
                        agree += 1
                    else:
                        disagree += 1
                flip[s] = disagree > agree
        keep_new = pos1 > out_pos[-1]
        for i in np.flatnonzero(keep_new):
            row = lines1[i]
            if flip.any():
                row = row[:9] + [
                    _swap_gt(row[9 + s]) if flip[s] else row[9 + s]
                    for s in range(n_samples)
                ]
            out_lines.append(row)
        out_pos = np.concatenate([out_pos, pos1[keep_new]])
        print_message(
            f"Ligated {path}: overlap {len(overlap)} sites, "
            f"{int(flip.sum())} samples flipped"
        )
    with BgzfWriter(out_path) as w:
        for h in header0:
            w.write(h if h.endswith("\n") else h + "\n")
        for row in out_lines:
            w.write("\t".join(row) + "\n")
    print_message(f"Wrote ligated VCF {out_path} ({len(out_lines)} records)")
