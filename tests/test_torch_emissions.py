"""The port's emission and GL functions (quilt_tpu_torch.kernels.emissions)
vs the JAX package's on the same reads and panel: whole-panel log eMatRead
and its per-call subset, windowed GLs, the scatter GL form and
emat_read_from_bits, all at atol 1e-4 (float32 sums in another order; the
JAX side's bf16 hi/lo products are exact to ~2^-17)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from quilt_tpu.io import simulate_panel, simulate_sample_reads
from quilt_tpu.io.simulate import simulate_truth_mosaic
from quilt_tpu.kernels import emissions as jem
from quilt_tpu.panel import assign_positions_to_grid
from quilt_tpu.utils import pack_bits_32

from quilt_tpu_torch.inputs import PaddedReads
from quilt_tpu_torch.kernels import emissions as tem

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(17)
    K, nSNPs, n_samples = 40, 320, 2
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs)
    grid, _, nGrids = assign_positions_to_grid(pos)
    reads = []
    for i in range(n_samples):
        truth = simulate_truth_mosaic(rng, haps, n_latent=2)
        r, _ = simulate_sample_reads(rng, truth, pos, grid, coverage=2.0 + i,
                                     read_length_bp=500, phred=25)
        reads.append(r.sorted_by_grid())
    pr = PaddedReads.build_batched(reads, ref_error=0.001)
    words = pack_bits_32(haps).view(np.int32)                     # [K, nGrids]
    return dict(pr=pr, words=words, nGrids=nGrids, K=K, rng=rng)


def _caches(w, Rc):
    pr = w["pr"]
    args = (pr.u_pad, pr.lpr, pr.lpa, pr.mask, w["nGrids"])
    ref = jem.ReadWindowCache(*args, Rc=Rc, lr=pr.lr, la=pr.la)
    got = tem.ReadWindowCache(*args, "cpu", Rc=Rc, lr=pr.lr, la=pr.la)
    return ref, got


def test_window_cache_and_whole_panel_emissions(world):
    ref, got = _caches(world, Rc=64)
    np.testing.assert_allclose(
        got.pr.numpy(), np.asarray(ref.pr[0], np.float32) + np.asarray(ref.pr[1], np.float32),
        atol=1e-4)
    E_ref = jem.expand_panel_bf16(jnp.asarray(world["words"]))
    E_got = tem.expand_panel(torch.from_numpy(world["words"]))
    np.testing.assert_array_equal(E_got.numpy(), np.asarray(E_ref, np.float32))
    dh, dl = ref.diff
    lf_ref = np.asarray(jem.lem_full_from_cache(E_ref, dh, dl, ref.base, ref.s0, ref.Rc, ref.Swin))
    lf_got = tem.lem_full_from_cache(E_got, got)
    np.testing.assert_allclose(lf_got.numpy(), lf_ref, atol=1e-4)

    rng = world["rng"]
    B, Ksub, K = 4, 24, world["K"]
    which = np.sort(np.stack([rng.choice(K, Ksub, replace=False) for _ in range(B)]), 1)
    flat = (np.repeat(np.arange(2), 2)[:, None] * K + which).astype(np.int32)
    R_out = world["pr"].nReads
    lem_r, skip_r = jem.lem_subset(jnp.asarray(lf_ref), jnp.asarray(flat), 1e4, R_out)
    lem_g, skip_g = tem.lem_subset(torch.from_numpy(lf_ref.copy()), torch.from_numpy(flat), 1e4, R_out)
    np.testing.assert_allclose(lem_g.numpy(), np.asarray(lem_r), atol=1e-4)
    np.testing.assert_array_equal(skip_g.numpy(), np.asarray(skip_r))


@pytest.mark.parametrize("C", [1, 3])
def test_windowed_gls(world, C):
    ref, got = _caches(world, Rc=64)
    rng = world["rng"]
    B = 2 * C
    H = rng.integers(0, 2, size=(B, world["pr"].nReads)).astype(np.int32)
    S = world["nGrids"] * 32
    g_ref = np.asarray(jem.gls_from_labels_windowed(ref, jnp.asarray(H), 2, C, S))
    g_got = tem.gls_from_labels_windowed(got, torch.from_numpy(H), 2, C, S)
    np.testing.assert_allclose(g_got.numpy(), g_ref, atol=1e-4)
    # the scatter form gives the same GLs from the chain-replicated reads
    pr = world["pr"]
    rep = lambda x: torch.from_numpy(np.repeat(x, C, axis=0))
    g_dev = tem.gls_from_labels_device(rep(pr.u_pad), rep(pr.lpr), rep(pr.lpa),
                                       torch.from_numpy(H), 2, S)
    g_dev_ref = np.asarray(jem.gls_from_labels_device(
        jnp.asarray(np.repeat(pr.u_pad, C, 0)), jnp.asarray(np.repeat(pr.lpr, C, 0)),
        jnp.asarray(np.repeat(pr.lpa, C, 0)), jnp.asarray(H), 2, S))
    np.testing.assert_allclose(g_dev.numpy(), g_dev_ref, atol=1e-4)
    np.testing.assert_allclose(g_dev.numpy(), g_got.numpy(), atol=1e-4)


def test_window_scatter_accumulates_duplicate_pads():
    """A read whose first base sits on its window's column 0 shares that
    column with every pad base of the chunk; the scatter must add, not
    pick one write."""
    u = np.array([[[0, 1, 0, 0], [2, 3, 4, 0]]], dtype=np.int32)      # [1, 2, 4]
    mask = np.array([[[1, 1, 0, 0], [1, 1, 1, 0]]], dtype=bool)
    lp = np.where(mask, -np.arange(1, 9, dtype=np.float32).reshape(1, 2, 4), 0.0)
    got = tem.ReadWindowCache(u, lp, lp, mask, G=1, device="cpu", Rc=2)
    want = np.zeros((1, 2, got.Swin), np.float32)
    for r in range(2):
        for j in range(4):
            if mask[0, r, j]:
                want[0, r, u[0, r, j]] += lp[0, r, j]
    np.testing.assert_array_equal(got.pr.numpy(), want)


def test_emat_read_from_bits(world):
    rng = world["rng"]
    pr = world["pr"]
    B, Ksub, K = 2, 16, world["K"]
    which = np.stack([rng.choice(K, Ksub, replace=False) for _ in range(B)])
    wsub = world["words"][which]                                   # [B, Ksub, G]
    R_out = pr.nReads + 64
    ref = np.asarray(jem.emat_read_from_bits(
        jnp.asarray(wsub), jnp.asarray(pr.u_pad), jnp.asarray(pr.lr),
        jnp.asarray(pr.la), 1e6, R_out=R_out))
    got = tem.emat_read_from_bits(
        torch.from_numpy(wsub), torch.from_numpy(pr.u_pad), torch.from_numpy(pr.lr),
        torch.from_numpy(pr.la), 1e6, R_out=R_out)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    sub = tem.gather_words(torch.from_numpy(world["words"]), torch.from_numpy(which))
    np.testing.assert_array_equal(sub.numpy(), wsub)
