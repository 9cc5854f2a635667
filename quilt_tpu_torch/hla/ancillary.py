"""HLA ancillary data: gene coordinates, strands, and anchor alleles.

Equivalent of the reference's `hla_ancillary_files/` package
(hlagenes.txt, quilt_hla_supplementary_info.txt; consumed at
QUILT/R/hla_prepare_functions.R:747-783 via `hla_gene_information`): the
GRCh38 genomic span of each HLA gene, and for the six canonical typing
genes the IPD-IMGT anchor allele + strand that orients the alignment
against the genome. Coordinates are public GRCh38 annotation facts.

With this table, `hla-prepare --region A` needs no explicit
--region_start/--region_end/--region_strand, and `hla --region_list
A,B,C` can type several genes in one invocation.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .db import HLAGene

# Name -> (chrom, start, end); GRCh38, 1-based inclusive (hlagenes.txt)
HLA_GENE_TABLE: Dict[str, Tuple[str, int, int]] = {
    "A": ("chr6", 29942554, 29945741),
    "B": ("chr6", 31353367, 31357155),
    "C": ("chr6", 31268257, 31272071),
    "DMA": ("chr6", 32948765, 32951900),
    "DMB": ("chr6", 32934806, 32940044),
    "DOA": ("chr6", 33006304, 33009150),
    "DOB": ("chr6", 32812540, 32816899),
    "DPA1": ("chr6", 33064319, 33073562),
    "DPA2": ("chr6", 33091485, 33097139),
    "DPB1": ("chr6", 33076065, 33087147),
    "DPB2": ("chr6", 33113855, 33129686),
    "DQA1": ("chr6", 32637480, 32643199),
    "DQA2": ("chr6", 32741532, 32747214),
    "DQB1": ("chr6", 32660035, 32666603),
    "DRA": ("chr6", 32440129, 32445274),
    "DRB1": ("chr6", 32578780, 32589729),
    "DRB5": ("chr6", 32518625, 32530185),
    "E": ("chr6", 30489540, 30492916),
    "F": ("chr6", 29723501, 29726666),
    "G": ("chr6", 29827859, 29830682),
    "HFE": ("chr6", 26087319, 26098343),
    "H": ("chr6", 29887803, 29890883),
    "J": ("chr6", 30006723, 30009476),
    "K": ("chr6", 29926466, 29929702),
    "L": ("chr6", 30259648, 30263000),
    "MICA": ("chr6", 31403653, 31415816),
    "MICB": ("chr6", 31498274, 31510557),
    "N": ("chr6", 30351570, 30351761),
    "P": ("chr6", 29800524, 29802776),
    "S": ("chr6", 31381834, 31382377),
    "TAP1": ("chr6", 32845139, 32853398),
    "TAP2": ("chr6", 32828449, 32837693),
    "T": ("chr6", 29896662, 29898450),
    "U": ("chr6", 29934121, 29934596),
    "V": ("chr6", 29792334, 29793434),
    "W": ("chr6", 29956609, 29959055),
}

# Canonical typing genes: anchor allele, its genome position, strand
# (quilt_hla_supplementary_info.txt)
HLA_SUPPLEMENTARY: Dict[str, Tuple[str, int, int]] = {
    "A": ("A*03:01:01:01", 29942554, 1),
    "B": ("B*07:02:01:01", 31357158, -1),
    "C": ("C*07:02:01:03", 31272071, -1),
    "DQA1": ("DQA1*01:02:01:01", 32637459, 1),
    "DQB1": ("DQB1*06:02:01:01", 32666607, -1),
    "DRB1": ("DRB1*15:01:01:01", 32589742, -1),
}

CANONICAL_GENES: List[str] = sorted(HLA_SUPPLEMENTARY)


def gene_info(name: str) -> Optional[HLAGene]:
    """HLAGene for a bare gene name ("A", "DRB1", or "HLA-A")."""
    key = name[4:] if name.startswith("HLA-") else name
    row = HLA_GENE_TABLE.get(key)
    if row is None:
        return None
    chrom, start, end = row
    return HLAGene(name=key, chrom=chrom, start=start, end=end)


def gene_strand(name: str) -> int:
    key = name[4:] if name.startswith("HLA-") else name
    row = HLA_SUPPLEMENTARY.get(key)
    return row[2] if row else 1
