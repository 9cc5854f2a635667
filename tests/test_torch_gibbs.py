"""The port's diploid Gibbs call (quilt_tpu_torch.kernels.gibbs) vs the JAX
package's run_gibbs_chains on its Pallas path (interpreted on the CPU),
with on-the-fly suffix-swap block moves, on the same emissions, uniforms
and block uniforms.

Tolerances: read labels agree on > 99.5% of reads; per-iteration
likelihoods rtol 1e-4 / atol 1e-3. The boundary detector and the pair-swap
parity are exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from quilt_tpu.io import simulate_panel, simulate_sample_reads
from quilt_tpu.io.simulate import simulate_truth_mosaic
from quilt_tpu.kernels import PaddedReads as JaxPaddedReads
from quilt_tpu.kernels import emissions as jem
from quilt_tpu.kernels.gibbs import GibbsInputs as JaxGibbsInputs
from quilt_tpu.kernels.gibbs import (
    _boundaries_from_rate, _pair_swap_parity, run_gibbs_chains as jax_run,
)
from quilt_tpu.panel import assign_positions_to_grid, trans_rates
from quilt_tpu.panel.prepare import smoothing_band
from quilt_tpu.utils import pack_bits_32

from quilt_tpu_torch.inputs import GibbsInputs
from quilt_tpu_torch.kernels.gibbs import (
    SlotLayout, boundaries_from_rate, pair_swap_parity, run_gibbs_chains,
)

torch.set_num_threads(2)


@pytest.mark.parametrize("iterative", [True, False])
def test_gibbs_call_matches_jax(iterative, monkeypatch):
    rng = np.random.default_rng(41 + iterative)
    K, nSNPs, n_samples, C = 30, 448, 2, 2
    Ksub, Kp = 24, 32
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs, region_span=300_000)
    grid, L_grid, nGrids = assign_positions_to_grid(pos)
    reads = []
    for _ in range(n_samples):
        truth = simulate_truth_mosaic(rng, haps, n_latent=2)
        r, _ = simulate_sample_reads(rng, truth, pos, grid, coverage=2.0,
                                     read_length_bp=500, phred=25)
        reads.append(r.sorted_by_grid())
    trans = trans_rates(rng.uniform(0.9, 0.999, nGrids - 1))
    B = n_samples * C
    gin = JaxGibbsInputs.build_batched(reads, trans, nGrids).repeat_rows(C)
    pr = JaxPaddedReads.build_batched(reads, ref_error=0.001)
    wc = jem.ReadWindowCache(pr.u_pad, pr.lpr, pr.lpa, pr.mask, nGrids,
                             lr=pr.lr, la=pr.la, Rc=64)
    words = pack_bits_32(haps).view(np.int32)
    lem_full = jem.lem_full_from_cache(jem.expand_panel_bf16(jnp.asarray(words)),
                                       *wc.diff, wc.base, wc.s0, wc.Rc, wc.Swin)
    which = np.sort(np.stack([rng.choice(K, Ksub, replace=False) for _ in range(B)]), 1)
    which = np.concatenate([which, np.repeat(which[:, :1], Kp - Ksub, 1)], 1)
    flat = np.repeat(np.arange(n_samples), C)[:, None] * K + which
    lem, skip = jem.lem_subset(lem_full, jnp.asarray(flat), 1e10, gin.R)
    n_its, NBu = 8, 6
    uniforms = rng.random((n_its, B, gin.R)).astype(np.float32)
    H0 = rng.integers(0, 2, size=(B, gin.R)).astype(np.int32)
    first = np.array([rng.integers(0, reads[b // C].nReads) for b in range(B)], np.int32)
    block_u = rng.random((n_its, NBu, 3, B)).astype(np.float32)
    do_block = np.zeros(n_its, bool)
    do_block[[2, 5]] = True
    band, idx0 = smoothing_band(L_grid, 5000)

    monkeypatch.setenv("QUILT_TPU_GIBBS", "pallas")
    ref = jax_run(
        bits=words[which], preads=pr,
        inputs=gin, uniforms=uniforms, H0=H0, first_read=first, n_latent=2,
        ff=0.0, n_burn_in=n_its - 1, iterative_init=iterative, K_real=Ksub,
        block_u=block_u, do_block=do_block, smooth_w=(band, idx0),
        quantile_prob=0.95, lem_read=(lem, skip),
    )
    port_in = GibbsInputs.build_batched(reads, trans, nGrids).repeat_rows(C)
    H, ll, uf, *_ = run_gibbs_chains(
        SlotLayout.build(port_in, B, "cpu"), torch.from_numpy(port_in.trans.T.copy()),
        torch.from_numpy(np.array(lem)), torch.from_numpy(np.array(skip)),
        torch.from_numpy(uniforms), torch.from_numpy(H0), torch.from_numpy(first),
        iterative, Ksub, block_u=torch.from_numpy(block_u), do_block=do_block,
        smooth_w=(torch.from_numpy(band), torch.from_numpy(idx0.astype(np.int64))),
        quantile_prob=0.95,
    )
    live = np.asarray(gin.read_mask)
    agree = (H.numpy()[live] == ref[3][live]).mean()
    assert agree > 0.995, f"label agreement {agree}"
    np.testing.assert_allclose(ll.numpy(), ref[4], rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(uf.numpy(), ref[5])


def test_boundaries_from_rate_exact():
    rng = np.random.default_rng(9)
    Gm, B = 120, 5
    L_grid = np.cumsum(rng.integers(500, 4000, Gm + 1))
    band, idx0 = smoothing_band(L_grid, 5000)
    # bumpy jump-rate profiles with hot stretches
    rate2 = (rng.random((Gm, B)) ** 4 + 3.0 * (rng.random((Gm, 1)) < 0.1)).astype(np.float32)
    for NB in (4, 32):
        ref = np.asarray(_boundaries_from_rate(
            jnp.asarray(rate2), (jnp.asarray(band), jnp.asarray(idx0)), NB, 0.9))
        got = boundaries_from_rate(
            torch.from_numpy(rate2),
            (torch.from_numpy(band), torch.from_numpy(idx0.astype(np.int64))), NB, 0.9)
        np.testing.assert_array_equal(got.numpy(), ref)
        assert (ref > 0).any()


def test_pair_swap_parity_exact():
    rng = np.random.default_rng(13)
    NB, B, G = 7, 6, 40
    C = rng.random((NB, B, 2, 2)).astype(np.float32)
    C[0, 0] = 0.0                                   # a degenerate junction
    u = rng.random((NB, B)).astype(np.float32)
    bnd = np.sort(np.where(rng.random((NB, B)) < 0.3, 0,
                           rng.integers(1, G, (NB, B))), axis=0).astype(np.int32)
    ref = np.asarray(_pair_swap_parity(jnp.asarray(C), jnp.asarray(u), jnp.asarray(bnd), G))
    got = pair_swap_parity(torch.from_numpy(C), torch.from_numpy(u), torch.from_numpy(bnd), G)
    np.testing.assert_array_equal(got.numpy(), ref)
