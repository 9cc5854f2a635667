"""The frozen work counts (benchmark/work.py) against chip_smoke.py's at
its timing shapes: the Gibbs sweeps at 512 grids x 56 chains x K = 640
(600 real), the fused FB at 112 rows x K = 5,120 x 512 grids."""
import numpy as np
import pytest
import torch

import chip_smoke
from benchmark import work


@pytest.mark.parametrize("want_alpha", [True, False])
def test_gibbs_sweep_counts_equal_chip_smokes(want_alpha):
    G, B, W, K, K_real, nl = 512, 56, 9, 640, 600, 2
    rng = np.random.default_rng(5)
    counts = rng.integers(0, W + 1, size=(G, B))
    valid = np.arange(W)[None, :, None] < counts[:, None, :]
    skip = (~valid | (rng.random((G, W, B)) < 0.05)).astype(np.int32)
    slots = torch.zeros((G, 4, W, B), dtype=torch.int32)
    slots[:, 2] = torch.as_tensor(skip)
    e = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt)
    args = [e(G, nl * B, K), e(G, nl * B, K), e(G, W, B, K), slots,
            e(B, 1, dt=torch.int32), e(B, nl), e(2, G), e(1, G, dt=torch.int32)]
    outs = [e(G, nl * B, K), e(G if want_alpha else 1, nl * B, K), e(G, W, B, dt=torch.int32),
            e(nl * B, 1), e(B, 1), e(B, nl)]
    n_live = int((skip == 0).sum())
    assert work.fwd_sweep_work(G, B, nl, K_real, G * W * B, n_live, want_alpha, K_pad=K) \
        == chip_smoke._fwd_work(args, outs, K_real)
    beta = e(G, nl * B, K)
    assert work.bwd_sweep_work(G, nl * B, K_real, K_pad=K) \
        == chip_smoke._bwd_work(args[0], args[6], beta, K_real)


def test_fused_fb_counts_equal_chip_smokes():
    from quilt_tpu_torch.kernels.fb import fused_cg
    B, K, Gp, K_top = 112, 5120, 512, 8
    CG = fused_cg(K, Gp)
    e = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt)
    dl, words, trans2 = e(B, 32 * Gp), e(Gp, K, dt=torch.int32), e(2, Gp)
    ck, lg, thin = e(Gp // CG, B, K), e(B), e(Gp, dt=torch.int32)
    d, tv, ti = e(B, 32 * Gp), e(Gp, B, K_top), e(Gp, B, K_top, dt=torch.int32)
    cells = B * Gp * K
    ck_bytes = ck.numel() * 4
    assert work.fb_forward_work(B, Gp, K, ckpt_bytes=ck_bytes) == (
        chip_smoke._nbytes(dl, words, trans2, ck, lg), 40 * cells)
    assert work.fb_backward_work(B, Gp, K, K_top, ckpt_bytes=ck_bytes) == (
        chip_smoke._nbytes(dl, words, ck, trans2, thin, d, tv, ti), 84 * cells)


def test_bound_equals_chip_smokes():
    for nbytes, flops in ((3.35e9, 1e9), (1e6, 6.7e12)):
        ms, _ = chip_smoke._bound(nbytes, flops)
        assert work.bound_s(nbytes, flops) * 1e3 == pytest.approx(ms, rel=1e-12)


def test_batch_count_is_the_algorithms_and_independent_of_the_fb_form():
    sizes = {"S": 32, "C": 7, "nl": 2, "G": 512, "Ksub": 600, "K": 5008, "n_its": 21,
             "n_alpha": 4, "n_calls": 6, "reads": 32 * 1640.0, "K_top": 8}
    w = work.batch_work(sizes)
    rows = 32 * 7 * 2
    # the FB: 84 operations a (row, grid, haplotype), six calls, no checkpoints
    assert w["fb"][1] == 6 * 84 * rows * 512 * 5008
    assert w["gibbs"][1] > 0 and w["gibbs"][0] > 0
