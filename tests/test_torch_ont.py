"""ONT-shaped reads in the port (20 kb reads at phred 10, ~10% base
errors), on the CPU: the per-read log emissions against the JAX package's
emission functions on the same reads, and the world of
tests/test_acceptance_ont.py through the port's quilt_impute against truth
and against the JAX engine.

Tolerances: the whole-panel log eMatRead of each package rtol 1e-5 of a
float64 sum of the same terms (sums of ~330 float32 terms; the JAX side's
bf16 hi/lo products are exact to ~2^-17 of a term), so the two within rtol
2e-5 of each other (measured: 5.1e-6 and 7.4e-6 of float64, 1.25e-5
apart); its per-call subset, rescaled to a maximum of 0, atol 1e-4 as
tests/test_torch_emissions.py holds it. Engine: r2 > 0.8 (the bound of
tests/test_acceptance_ont.py) for each seed, and the port's r2 averaged
over 3 seeds within 0.03 of the JAX engine's (the tolerance of
tests/test_torch_engine.py; the two engines draw from different
generators, so their r2 agree only statistically)."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from quilt_tpu.config import ImputeConfig as JaxImputeConfig
from quilt_tpu.engine import quilt_impute as jax_quilt_impute
from quilt_tpu.io import simulate_panel, simulate_sample_reads
from quilt_tpu.io.simulate import simulate_truth_mosaic
from quilt_tpu.kernels import emissions as jem
from quilt_tpu.panel import assign_positions_to_grid, prepare_panel
from quilt_tpu.utils import pack_bits_32

from quilt_tpu_torch.config import ImputeConfig
from quilt_tpu_torch.engine.driver import quilt_impute
from quilt_tpu_torch.inputs import PaddedReads
from quilt_tpu_torch.kernels import emissions as tem

torch.set_num_threads(2)
SEEDS = (0, 1, 2)
MAX_DIFF = 1e10


@pytest.fixture(scope="module")
def long_reads():
    """20 kb reads at phred 10 over SNPs ~60 bp apart (~330 SNPs a read,
    ~10 grids), two samples at 2x and 3x, grid-sorted and padded."""
    rng = np.random.default_rng(23)
    K, nSNPs = 64, 2048
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs, region_span=nSNPs * 60)
    grid, _, nGrids = assign_positions_to_grid(pos)
    reads = []
    for cov in (2.0, 3.0):
        truth = simulate_truth_mosaic(rng, haps, n_latent=2)
        r, _ = simulate_sample_reads(rng, truth, pos, grid, coverage=cov,
                                     read_length_bp=20_000, phred=10)
        reads.append(r.sorted_by_grid())
    pr = PaddedReads.build_batched(reads, ref_error=0.001)
    return dict(pr=pr, words=pack_bits_32(haps).view(np.int32), nGrids=nGrids, K=K, rng=rng,
                reads=reads, haps=haps)


def _lem_float64(w):
    """The whole-panel log eMatRead [2 * K, R] in float64: a read's log
    emission for haplotype k is sum_j lr_j + bit(k, u_j) (la_j - lr_j)."""
    pr, H = w["pr"], w["haps"].astype(np.float64)
    out = np.zeros((2, w["K"], pr.nReads))
    for s in range(2):
        for r in range(pr.nReads):
            m = pr.mask[s, r]
            lr = pr.lr[s, r][m].astype(np.float64)
            out[s, :, r] = lr.sum() + H[:, pr.u_pad[s, r][m]] @ (pr.la[s, r][m] - lr)
    return out.reshape(2 * w["K"], pr.nReads)


def test_long_phred10_read_emissions_match_jax(long_reads):
    w, pr = long_reads, long_reads["pr"]
    assert min(np.diff(r.offsets).mean() for r in w["reads"]) > 200     # genuinely long
    args = (pr.u_pad, pr.lpr, pr.lpa, pr.mask, w["nGrids"])
    ref = jem.ReadWindowCache(*args, Rc=64, lr=pr.lr, la=pr.la)
    got = tem.ReadWindowCache(*args, "cpu", Rc=64, lr=pr.lr, la=pr.la)
    assert got.Swin == ref.Swin and got.Swin > 8 * 32         # a chunk's window spans > 8 grids
    E_ref = jem.expand_panel_bf16(jnp.asarray(w["words"]))
    dh, dl = ref.diff
    lf_ref = np.asarray(jem.lem_full_from_cache(E_ref, dh, dl, ref.base, ref.s0, ref.Rc, ref.Swin))
    lf_got = tem.lem_full_from_cache(tem.expand_panel(torch.from_numpy(w["words"])), got).numpy()
    per_sample = lf_ref.reshape(2, w["K"], -1)
    for s, r in enumerate(w["reads"]):                # ~330 terms of -0.1 to -2.3 nats a read
        assert np.abs(per_sample[s, :, :r.nReads]).min() > 10
    f64 = _lem_float64(w)
    np.testing.assert_allclose(lf_got[:, :pr.nReads], f64, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lf_ref[:, :pr.nReads], f64, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lf_got, lf_ref, rtol=2e-5, atol=1e-6)

    rng = w["rng"]
    B, Ksub = 4, 24
    which = np.sort(np.stack([rng.choice(w["K"], Ksub, replace=False) for _ in range(B)]), 1)
    flat = (np.repeat(np.arange(2), 2)[:, None] * w["K"] + which).astype(np.int32)
    R_out = pr.nReads
    lem_r, skip_r = jem.lem_subset(jnp.asarray(lf_ref), jnp.asarray(flat), MAX_DIFF, R_out)
    lem_g, skip_g = tem.lem_subset(torch.from_numpy(lf_ref.copy()), torch.from_numpy(flat),
                                   MAX_DIFF, R_out)
    np.testing.assert_allclose(lem_g.numpy(), np.asarray(lem_r), atol=1e-4)
    np.testing.assert_array_equal(skip_g.numpy(), np.asarray(skip_r))
    # the maxDifferenceBetweenReads floor acts on these reads (a 600 bp
    # read's spread stays far above it)
    floor = -math.log(MAX_DIFF)
    assert (lem_g.numpy() <= floor + 1e-4).mean() > 0.05


def _acceptance_world(seed):
    """tests/test_acceptance_ont.py's world from a seed: K 100, 512 SNPs,
    one sample of 20 kb reads at 1x, phred 10."""
    rng = np.random.default_rng(seed)
    K, nSNPs = 100, 512
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs)
    prep = prepare_panel(chrom="chr20", pos=pos, ref_allele=np.array(["A"] * nSNPs),
                         alt_allele=np.array(["G"] * nSNPs), haps=haps, nMaxDH=64)
    truth = simulate_truth_mosaic(rng, haps, n_latent=2)
    reads, _ = simulate_sample_reads(rng, truth, pos, prep.grid, coverage=1.0,
                                     read_length_bp=20_000, phred=10)
    return prep, reads, truth.sum(axis=0)[:, None].astype(float)


CFG = dict(nGibbsSamples=3, n_seek_its=2, Ksubset=48, Knew=48,
           small_ref_panel_gibbs_iterations=10, seed=2)


@pytest.fixture(scope="module")
def r2_by_seed():
    """{seed: (port r2, JAX r2)} on the acceptance world."""
    out = {}
    for seed in SEEDS:
        prep, reads, truth_gen = _acceptance_world(seed)
        got = quilt_impute(prep, [reads], ["ONT0"], ImputeConfig(**CFG), "cpu",
                           truth_gen=truth_gen)
        ref = jax_quilt_impute(prep, [reads], ["ONT0"], JaxImputeConfig(**CFG),
                               truth_gen=truth_gen)
        assert got.results[0].imputed and ref.results[0].imputed
        out[seed] = (got.r2_per_sample[0], ref.r2_per_sample[0])
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_ont_engine_r2_above_the_acceptance_bound(r2_by_seed, seed):
    assert r2_by_seed[seed][0] > 0.8, r2_by_seed


def test_ont_engine_r2_matches_jax(r2_by_seed):
    port = np.mean([v[0] for v in r2_by_seed.values()])
    jax_ = np.mean([v[1] for v in r2_by_seed.values()])
    assert abs(port - jax_) < 0.03, r2_by_seed
