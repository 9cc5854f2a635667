"""The port's genome chunk map and phase-aware VCF ligation (dist/ligate.py),
as tests/test_ligate.py holds the JAX package's."""
import numpy as np

from quilt_tpu_torch.dist.ligate import Chunk, ligate_vcfs, quilt_chunk_map
from quilt_tpu_torch.out.bgzf import BgzfWriter, bgzf_open


def test_chunk_map_covers_chromosome():
    pos = np.arange(1, 20_000_000, 2000)
    cm = pos / 1e6  # 1 cM/Mb
    chunks = quilt_chunk_map("chr1", pos, cm, min_bp=3_000_000, min_cm=4.0)
    assert len(chunks) >= 3
    assert chunks[0].start == 1
    # consecutive chunks overlap
    for a, b in zip(chunks, chunks[1:]):
        assert b.start < a.end
    assert chunks[-1].end >= pos[-1]


def _write_chunk_vcf(path, pos, gts):
    with BgzfWriter(path) as w:
        w.write("##fileformat=VCFv4.0\n")
        w.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS0\n")
        for p, gt in zip(pos, gts):
            w.write(
                f"1\t{p}\t.\tA\tG\t.\tPASS\t.\tGT:GP:DS:HD\t"
                f"{gt}:1,0,0:0.5:0.2,0.3\n"
            )


def test_ligate_flips_phase(tmp_path):
    # chunk 1: hets phased 0|1 at sites 100..600
    pos1 = [100, 200, 300, 400, 500, 600]
    gts1 = ["0|1"] * 6
    # chunk 2 overlaps at 500,600 with OPPOSITE phase => must be flipped
    pos2 = [500, 600, 700, 800]
    gts2 = ["1|0", "1|0", "1|0", "0|1"]
    p1 = str(tmp_path / "c1.vcf.gz")
    p2 = str(tmp_path / "c2.vcf.gz")
    _write_chunk_vcf(p1, pos1, gts1)
    _write_chunk_vcf(p2, pos2, gts2)
    out = str(tmp_path / "lig.vcf.gz")
    ligate_vcfs([p1, p2], out)
    body = [l for l in bgzf_open(out) if not l.startswith("#")]
    assert len(body) == 8   # 6 + 2 new
    by_pos = {int(l.split("\t")[1]): l.split("\t")[9].split(":")[0]
              for l in body}
    assert by_pos[700] == "0|1"   # flipped from 1|0
    assert by_pos[800] == "1|0"   # flipped from 0|1
    # HD swapped as well
    hd = [l for l in body if l.split("\t")[1] == "700"][0]
    assert hd.split("\t")[9].split(":")[3].startswith("0.3")
