"""The Gibbs dosage pass and the QUILT2 pieces around it, against the JAX
package on the same inputs (numpy-seeded):

- dosage_sweep_plain vs the Pallas _dosage_sweep (interpreted on the CPU),
  with K_real < K: atol 1e-5 (float32 sums over K in another order);
- the port's Gibbs call with packed subset words vs the JAX
  run_gibbs_chains on its packed-word Pallas path, same uniforms: labels
  agree on > 99.5% of reads, hap dosages and gp atol 5e-3 (the JAX Gibbs
  tests' tolerance);
- symbols_device vs the host symbols_from_hap_dosage: equal;
- the all-SNP panel vs build_subset_bits_all, and initial_all_snp_labels
  under the same rng: equal."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from quilt_tpu.engine import rare_common as jrc
from quilt_tpu.io import simulate_panel, simulate_sample_reads
from quilt_tpu.io.simulate import simulate_truth_mosaic
from quilt_tpu.kernels import PaddedReads as JaxPaddedReads
from quilt_tpu.kernels.gibbs import GibbsInputs as JaxGibbsInputs
from quilt_tpu.kernels.gibbs import run_gibbs_chains as jax_run
from quilt_tpu.kernels.gibbs_pallas import _dosage_sweep
from quilt_tpu.panel import assign_positions_to_grid, prepare_panel, trans_rates
from quilt_tpu.panel.mspbwt import symbols_from_hap_dosage
from quilt_tpu.utils import pack_bits_32

from quilt_tpu_torch.engine.rare_common import (
    all_snp_panel, initial_all_snp_labels, restrict_reads_to_common,
)
from quilt_tpu_torch.inputs import GibbsInputs, PaddedReads
from quilt_tpu_torch.kernels import gibbs_dosage
from quilt_tpu_torch.kernels.emissions import emat_read_from_bits
from quilt_tpu_torch.kernels.gibbs import SlotLayout, run_gibbs_chains
from quilt_tpu_torch.panel.mspbwt import distinct_hap_bits, symbols_device

torch.set_num_threads(2)


def test_deferred_normalisation_equals_normalise_first():
    """The dosage kernel's one-pass form, in float64: with s = sum_k ab_k and
    X_t = sum of ab_k over the haplotypes whose bit t is set,
    ((1 - 2 eps) X_t + eps s) / max(s, 1e-30) equals normalising gamma =
    ab / max(s, 1e-30) first and contracting with bit * (1 - 2 eps) + eps;
    an all-zero row gives 0 either way."""
    rng = np.random.default_rng(8)
    eps = 0.001
    ab = rng.uniform(0.0, 1.0, (6, 700)) * rng.uniform(1e-20, 1e3, (6, 1))
    ab[0] = 0.0
    ab[1, 600:] = 0.0
    bits = rng.integers(0, 2, (6, 700, 32)).astype(np.float64)
    s = ab.sum(1)
    deferred = ((1 - 2 * eps) * np.einsum("rk,rkt->rt", ab, bits) + eps * s[:, None]) \
        / np.maximum(s, 1e-30)[:, None]
    gamma = ab / np.maximum(s, 1e-30)[:, None]
    first = np.einsum("rk,rkt->rt", gamma, bits * (1 - 2 * eps) + eps)
    np.testing.assert_allclose(deferred, first, rtol=1e-13, atol=0)
    assert not deferred[0].any() and not first[0].any()


@pytest.mark.parametrize("G,B,K,K_real,chunk_bytes,nl", [
    (3, 2, 128, 100, 1 << 27, 2),
    (7, 3, 256, 256, 1 << 27, 2),
    (5, 4, 384, 301, 4 * 384 * 32 * 4 * 2, 2),  # two grids per plain-version step
    (4, 3, 128, 100, 1 << 27, 3),               # NIPT: three latent rows a chain
    (5, 2, 256, 256, 2 * 256 * 32 * 4 * 2, 3),
    (2, 1, 20000, 19990, 1 << 27, 2),           # past the previous kernel's shared memory
])
def test_dosage_plain_matches_pallas(G, B, K, K_real, chunk_bytes, nl, monkeypatch):
    monkeypatch.setattr(gibbs_dosage, "_PLAIN_CHUNK_BYTES", chunk_bytes)
    rng = np.random.default_rng(G * 100 + K)
    alphas = rng.uniform(0.0, 1.0, (G, nl * B, K)).astype(np.float32)
    beta = rng.uniform(0.1, 1.0, (G, nl * B, K)).astype(np.float32)
    alphas[0, 1] = 0.0                          # a row with no mass: floor 1e-30
    words = rng.integers(-2**31, 2**31, (G, B, K)).astype(np.int32)
    ref = np.asarray(_dosage_sweep(jnp.asarray(alphas), jnp.asarray(beta), jnp.asarray(words),
                                   nl=nl, K_real=K_real, ref_error=0.001))
    got = gibbs_dosage.dosage_sweep(torch.from_numpy(alphas), torch.from_numpy(beta),
                                    torch.from_numpy(words), nl, K_real, 0.001)
    assert got.shape == (G, nl * B, 32)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_gibbs_call_dosages_match_jax(monkeypatch):
    rng = np.random.default_rng(23)
    K, nSNPs, B = 40, 200, 3
    Ksub, Kp = 30, 40
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs)
    grid, L_grid, nGrids = assign_positions_to_grid(pos)
    reads = []
    for _ in range(B):
        truth = simulate_truth_mosaic(rng, haps, n_latent=2)
        r, _ = simulate_sample_reads(rng, truth, pos, grid, coverage=3.0,
                                     read_length_bp=600, phred=25)
        reads.append(r.sorted_by_grid())
    trans = trans_rates(np.full(nGrids - 1, 0.985))
    words = pack_bits_32(haps).view(np.int32)
    which = np.sort(np.stack([rng.choice(K, Ksub, replace=False) for _ in range(B)]), 1)
    which = np.concatenate([which, np.repeat(which[:, :1], Kp - Ksub, 1)], 1)
    gin = JaxGibbsInputs.build_batched(reads, trans, nGrids)
    n_its = 5
    uniforms = rng.random((n_its, B, gin.R)).astype(np.float32)
    H0 = rng.integers(0, 2, size=(B, gin.R)).astype(np.int32)
    first = np.array([rng.integers(0, r.nReads) for r in reads], np.int32)
    monkeypatch.setenv("QUILT_TPU_GIBBS", "pallas")
    ref = jax_run(bits=words[which], preads=JaxPaddedReads.build_batched(reads, ref_error=0.001),
                  inputs=gin, uniforms=uniforms, H0=H0, first_read=first, n_latent=2,
                  ff=0.0, n_burn_in=n_its - 1, iterative_init=True, K_real=Ksub)

    port_in = GibbsInputs.build_batched(reads, trans, nGrids)
    pr = PaddedReads.build_batched(reads, ref_error=0.001)
    w_t = torch.from_numpy(words[which])
    em = emat_read_from_bits(w_t, torch.from_numpy(pr.u_pad), torch.from_numpy(pr.lr),
                             torch.from_numpy(pr.la), 1e10, R_out=port_in.R)
    H, _, uf, hap_dos, gp, *_ = run_gibbs_chains(
        SlotLayout.build(port_in, B, "cpu"), torch.from_numpy(port_in.trans.T.copy()),
        torch.log(em), (em.amax(1) - em.amin(1)) <= 1e-9, torch.from_numpy(uniforms),
        torch.from_numpy(H0), torch.from_numpy(first), True, Ksub, words=w_t, ref_error=0.001)
    live = np.asarray(gin.read_mask)
    assert (H.numpy()[live] == ref[3][live]).mean() > 0.995
    assert not uf.any() and not ref[5].any()
    assert hap_dos.shape == (B, 2, nGrids * 32) and gp.shape == (B, 3, nGrids * 32)
    np.testing.assert_allclose(hap_dos.numpy()[:, :, :nSNPs], ref[2][:, :, :nSNPs], atol=5e-3)
    np.testing.assert_allclose(gp.numpy()[:, :, :nSNPs], ref[0][:, :, :nSNPs], atol=5e-3)


def test_symbols_device_matches_host():
    rng = np.random.default_rng(5)
    K, nSNPs = 60, 300                                # 10 grids, the last one partial
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs)
    prep = prepare_panel(chrom="chr20", pos=pos, ref_allele=np.array(["A"] * nSNPs),
                         alt_allele=np.array(["G"] * nSNPs), haps=haps, nMaxDH=6)
    # dosages near panel haplotypes, with flips and values on both sides of 0.5
    src = haps[rng.integers(0, K, (4, 2))].astype(np.float64)
    flip = rng.random(src.shape) < 0.05
    hd = np.abs(src - flip) * 0.9 + rng.uniform(0.0, 0.1, src.shape)
    got = symbols_device(torch.from_numpy(hd.astype(np.float32)),
                         distinct_hap_bits(prep.panel, "cpu"), nSNPs).numpy()
    assert got.dtype == np.uint8 and got.shape == (4, 2, prep.nGrids)
    for b in range(4):
        for h in range(2):
            ref = symbols_from_hap_dosage(hd[b, h].astype(np.float32),
                                          prep.panel.distinctHapsB, nSNPs)
            np.testing.assert_array_equal(got[b, h], ref)


@pytest.fixture(scope="module")
def rare_prep():
    rng = np.random.default_rng(11)
    K, nSNPs = 50, 330
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs)
    for s in rng.choice(nSNPs, 30, replace=False):
        haps[:, s] = 0
        haps[rng.choice(K, int(rng.integers(1, 3)), replace=False), s] = 1
    prep = prepare_panel(chrom="chr20", pos=pos, ref_allele=np.array(["A"] * nSNPs),
                         alt_allele=np.array(["G"] * nSNPs), haps=haps,
                         impute_rare_common=True, rare_af_threshold=0.05)
    return prep, haps, pos, rng


def test_all_snp_panel_matches_subset_bits(rare_prep):
    prep, haps, _, rng = rare_prep
    assert (~prep.snp_is_common).sum() >= 30
    nGrids_all = len(prep.L_grid_all)
    rhb_all = all_snp_panel(prep.rhb_t, prep.snp_is_common, prep.rare_per_hap_info, nGrids_all)
    assert rhb_all.dtype == np.int32 and rhb_all.shape == (prep.K, nGrids_all)
    which = np.sort(np.stack([rng.choice(prep.K, 20, replace=False) for _ in range(3)]), 1)
    ref = jrc.build_subset_bits_all(prep.rhb_t, which, prep.snp_is_common,
                                    prep.rare_per_hap_info, nGrids_all)
    for b in range(3):
        np.testing.assert_array_equal(rhb_all[which[b]], pack_bits_32(ref[b]).view(np.int32))
    np.testing.assert_array_equal(rhb_all.view(np.uint32), pack_bits_32(haps))


def test_rare_common_reads_and_labels_match_jax(rare_prep):
    prep, haps, pos, rng = rare_prep
    truth = simulate_truth_mosaic(rng, haps, n_latent=2)
    reads, _ = simulate_sample_reads(rng, truth, pos, prep.grid_all, coverage=3.0,
                                     read_length_bp=500, phred=25)
    got = restrict_reads_to_common(reads, prep.snp_is_common, prep.grid)
    ref = jrc.restrict_reads_to_common(reads, prep.snp_is_common, prep.grid)
    for f in ("u", "bq", "offsets", "wif0"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    hd = rng.random((2, prep.nSNPs))
    labels = initial_all_snp_labels(reads, hd, prep.snp_is_common, 2, 0.0,
                                    np.random.default_rng(3))
    ref_labels = jrc.initial_all_snp_labels(reads, hd, prep.snp_is_common, 2, 0.0,
                                            np.random.default_rng(3))
    np.testing.assert_array_equal(labels, ref_labels)
    assert 0 < labels.mean() < 1


def test_dosage_refuses_other_row_counts():
    a = torch.zeros((2, 8, 16))
    with pytest.raises(ValueError, match="nl must be 2 or 3"):
        gibbs_dosage.dosage_sweep(a, a, torch.zeros((2, 2, 16), dtype=torch.int32), 4, 16, 0.001)
    with pytest.raises(ValueError, match="nl must be 2 or 3"):
        gibbs_dosage.dosage_sweep(a, a, torch.zeros((2, 4, 16), dtype=torch.int32), 3, 16, 0.001)
