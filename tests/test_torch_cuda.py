"""The port's CUDA kernels against their plain versions, and the engine on
the GPU (QUILT1 and QUILT2), at small shapes that reach the kernels' edge
cases (fewer haplotypes than threads, padded haplotypes, more than 64
reads in a grid, the iterative-init modes). They need an NVIDIA GPU and
nvcc and skip elsewhere; on the GPU machine, which has no jax, run them
with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: as chip_smoke.py states them (labels > 0.995 with the state
compared on chains whose labels all agree at rtol 1e-4 / atol 1e-3; beta
rtol 1e-5; FB dosage and top-K atol 1e-4; Gibbs dosages atol 1e-5; the
K-split FB: emission maxima exact, checkpoints and S rtol 1e-5, remat
alphas atol 1e-6, dosage and top-K atol 1e-4)."""
import numpy as np
import pytest
import torch

from quilt_tpu_torch.kernels import fb as fbk
from quilt_tpu_torch.kernels import gibbs_dosage as gd
from quilt_tpu_torch.kernels import gibbs_sweep as gs
from quilt_tpu_torch.simulate import make_world, random_sweep_state

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _sweep_variants(K):
    """The kernel variants that hold K: the default, each explicit thread
    count as far as instantiated, and the general (local-array) variant."""
    return [None, -1] + [t for t, cap in ((64, 640), (128, 1024), (256, 2048)) if K <= cap]


@pytest.mark.parametrize("it_mode,G,B,W,K,K_real,max_reads,p_skip,dead_grid", [
    (0, 9, 3, 6, 40, 36, 6, 0.05, None),
    (1, 9, 3, 6, 40, 36, 6, 0.05, None),
    (2, 9, 3, 6, 40, 36, 6, 0.05, None),
    (2, 4, 2, 96, 300, 290, 90, 0.05, None),
    (2, 9, 3, 6, 41, 37, 6, 0.05, None),         # K no multiple of 4 or of the threads
    (0, 9, 3, 6, 41, 41, 6, 0.5, 4),             # a grid with no live slot; mostly skipped
    (2, 1, 2, 5, 40, 36, 5, 0.05, None),         # one grid
    (2, 1, 2, 5, 40, 36, 5, 0.05, 0),            # one grid and nothing to do
    (2, 5, 2, 40, 640, 600, 35, 0.3, 2),         # the main path's K, two slot chunks
    (1, 4, 2, 6, 1100, 1000, 6, 0.05, None),     # above the 128-thread variants
    (2, 4, 2, 6, 2100, 2050, 6, 0.05, None),     # above every register variant
    (2, 3, 2, 4, 2101, 2101, 4, 0.05, 1),        # the same, 4-byte copies
    (1, 4, 2, 3, 9000, 8990, 3, 0.05, 2),        # the rings shrunk to one stage each
])
def test_sweep_kernels_match_plain(cuda, it_mode, G, B, W, K, K_real, max_reads, p_skip,
                                   dead_grid):
    rng = np.random.default_rng(100 + it_mode + W)
    state = list(random_sweep_state(rng, G, B, W, K, K_real, max_reads, p_skip))
    if dead_grid is not None:
        state[3][dead_grid, 2] = 1
    args = [torch.from_numpy(x).to(cuda) for x in state]
    live = args[3][:, 2] == 0
    for want_alpha in (True, False):
        ref = gs.fwd_sweep_plain(*args, K_real=K_real, it_mode=it_mode,
                                 want_alpha=want_alpha)
        for variant in _sweep_variants(K):
            got = gs.fwd_sweep(*args, nl=2, K_real=K_real, it_mode=it_mode,
                               prior=(0.5, 0.5), want_alpha=want_alpha, _variant=variant)
            if live.any():
                assert (got[2][live] == ref[2][live]).float().mean().item() > 0.995
            assert torch.equal(got[2][~live], ref[2][~live])
            same = ((got[2] == ref[2]) | ~live).all(0).all(0)
            rows = torch.cat([same, same])
            assert same.any()
            torch.testing.assert_close(got[0][:, rows], ref[0][:, rows], rtol=1e-4, atol=1e-3)
            torch.testing.assert_close(got[3][rows], ref[3][rows], rtol=1e-4, atol=1e-3)
            torch.testing.assert_close(got[5][same], ref[5][same], rtol=0, atol=0)
            assert torch.equal(got[4], ref[4])
            if want_alpha:
                torch.testing.assert_close(got[1][:, rows], ref[1][:, rows],
                                           rtol=1e-4, atol=1e-6)
    ref_b = gs.bwd_sweep_plain(args[0], args[6], K_real)
    for variant in _sweep_variants(K):
        beta = gs.bwd_sweep(args[0], args[6], nl=2, K_real=K_real, _variant=variant)
        torch.testing.assert_close(beta, ref_b, rtol=1e-5, atol=1e-6)
    if 512 < K <= 640:     # the look-ahead form of the backward step, where it is built
        beta = gs.bwd_sweep(args[0], args[6], nl=2, K_real=K_real, _variant=128, _ahead=True)
        torch.testing.assert_close(beta, ref_b, rtol=1e-5, atol=1e-6)


def test_sweep_kernels_refuse_a_variant_that_does_not_hold_k(cuda):
    """An explicit thread count never gives way to another variant."""
    args = [torch.from_numpy(x).to(cuda) for x in random_sweep_state(
        np.random.default_rng(1), 2, 1, 2, 700, 700, 2)]
    with pytest.raises(RuntimeError, match="gibbs_fwd"):
        gs.fwd_sweep(*args, nl=2, K_real=700, it_mode=2, prior=(0.5, 0.5), _variant=64)
    with pytest.raises(RuntimeError, match="gibbs_bwd"):
        gs.bwd_sweep(args[0], args[6], nl=2, K_real=700, _variant=64)


@pytest.mark.parametrize("K,B", [(90, 5), (700, 3)])
def test_fb_kernels_match_plain(cuda, K, B):
    from quilt_tpu_torch.inputs import FBInputs, thinned_grids
    from quilt_tpu_torch.panel.prepare import trans_rates

    world = make_world(np.random.default_rng(K), K=K, nSNPs=1100, n_samples=1)
    prep = world["prep"]
    fb = FBInputs.build(prep.panel, trans_rates(prep.sigma),
                        thinned_grids=thinned_grids(prep.nGrids, 0.3))
    dev = fb.device_tensors(cuda)
    gen = torch.Generator(device=cuda).manual_seed(K)
    gl = 0.05 + 0.95 * torch.rand((B, 2, fb.S), generator=gen, device=cuda)
    got = fbk.fb_full_batched(gl, fb, K_top=8)
    words, trans2, thin = dev["words"], dev["trans2"], dev["thin_flag"]
    dl = (torch.log(gl[:, 1] * 0.999 + gl[:, 0] * 0.001)
          - torch.log(gl[:, 0] * 0.999 + gl[:, 1] * 0.001)).contiguous()
    ck, lg = fbk.fb_forward_plain(dl, words, trans2, K)
    ck_k, lg_k = fbk.fb_forward(dl, words, trans2, K)
    torch.testing.assert_close(ck_k, ck, rtol=0, atol=1e-5)
    torch.testing.assert_close(lg_k, lg, rtol=1e-5, atol=1e-2)
    d, tv, ti = fbk.fb_backward_plain(dl, words, ck, trans2, thin, K, 8, 0.001)
    torch.testing.assert_close(got[0], d, rtol=0, atol=1e-4)
    torch.testing.assert_close(got[2], tv, rtol=0, atol=1e-4)
    g = thin >= 0
    firm = (tv[g][:, :, :-1] - tv[g][:, :, 1:]) > 1e-3
    assert torch.equal(got[3][g][:, :, :-1][firm], ti[g][:, :, :-1][firm])
    assert not got[2][~g].any()


@pytest.mark.parametrize("K,B,splits", [(90, 5, 2), (700, 3, 8), (700, 3, 1), (3000, 2, 4)])
def test_fb_tiled_kernels_match_plain(cuda, K, B, splits):
    """Each K-split kernel against its plain version, the whole tiled FB
    against the fused CUDA FB, launch counts, and run-to-run equality."""
    from quilt_tpu_torch.inputs import FBInputs, thinned_grids
    from quilt_tpu_torch.panel.prepare import trans_rates

    world = make_world(np.random.default_rng(K), K=K, nSNPs=1100, n_samples=1)
    prep = world["prep"]
    fb = FBInputs.build(prep.panel, trans_rates(prep.sigma),
                        thinned_grids=thinned_grids(prep.nGrids, 0.3))
    dev = fb.device_tensors(cuda)
    words, trans2, thin = dev["words"], dev["trans2"], dev["thin_flag"]
    gen = torch.Generator(device=cuda).manual_seed(K)
    gl = 0.05 + 0.95 * torch.rand((B, 2, fb.S), generator=gen, device=cuda)
    dl, _ = fbk._gl_log_ratios(gl, 0.001)
    kt = fb.K_pad // splits
    CG, NSC = fbk.GRID_CHUNK, fb.nGrids // fbk.GRID_CHUNK
    kernels = [fbk.MAX_TILED_KERNEL, fbk.FWD_TILED_KERNEL, fbk.REMAT_TILED_KERNEL,
               fbk.BWD_TILED_KERNEL]
    for k in kernels:
        k.launches = 0
    mx = fbk.fb_max_tiled(dl, words, K, kt)
    assert torch.equal(mx, fbk.fb_max_tiled_plain(dl, words, K, kt))
    ck, S, lg = fbk.fb_forward_tiled(dl, words, trans2, mx, K, kt)
    ck_r, S_r, lg_r = fbk.fb_forward_tiled_plain(dl, words, trans2, mx, K, kt)
    torch.testing.assert_close(ck, ck_r, rtol=1e-5, atol=1e-30)
    torch.testing.assert_close(S, S_r, rtol=1e-5, atol=0)
    torch.testing.assert_close(lg, lg_r, rtol=1e-5, atol=1e-2)
    eb = torch.ones((B, fb.K_pad), device=cuda)
    E = torch.full((B,), float(K), device=cuda)
    for ci in range(NSC - 1, -1, -1):
        al = fbk.fb_remat_tiled(dl, words, ck[ci], trans2, mx, S, ci, K, kt)
        torch.testing.assert_close(
            al, fbk.fb_remat_tiled_plain(dl, words, ck[ci], trans2, mx, S, ci, K, kt),
            rtol=0, atol=1e-6)
        bargs = (dl, words, al, trans2, thin, mx, eb, E, ci, K, 8, 0.001, kt)
        got = fbk.fb_backward_tiled(*bargs)
        ref = fbk.fb_backward_tiled_plain(*bargs)
        torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-4)
        torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-4)
        g = thin[ci * CG:(ci + 1) * CG] >= 0
        firm = (ref[1][g][:, :, :-1] - ref[1][g][:, :, 1:]) > 1e-3
        assert torch.equal(got[2][g][:, :, :-1][firm], ref[2][g][:, :, :-1][firm])
        assert not got[1][~g].any() and not got[2][~g].any()
        torch.testing.assert_close(got[3], ref[3], rtol=1e-4, atol=1e-30)
        torch.testing.assert_close(got[4], ref[4], rtol=1e-4, atol=0)
        eb, E = got[3], got[4]
    assert [k.launches for k in kernels] == [1, 1, NSC, NSC]
    args = (gl, words, trans2, thin, K, 8, 0.001)
    tiled = fbk.fb_tiled_core(*args, k_tile=kt)
    fused = fbk.fb_core(*args)
    torch.testing.assert_close(tiled[0], fused[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(tiled[1], fused[1], rtol=1e-5, atol=1e-2)
    torch.testing.assert_close(tiled[2], fused[2], rtol=0, atol=1e-4)
    g = thin >= 0
    firm = (fused[2][g][:, :, :-1] - fused[2][g][:, :, 1:]) > 1e-3
    assert torch.equal(tiled[3][g][:, :, :-1][firm], fused[3][g][:, :, :-1][firm])
    again = fbk.fb_tiled_core(*args, k_tile=kt)
    assert all(torch.equal(a, b) for a, b in zip(tiled, again))
    forced = fbk.fb_full_batched(gl, fb, K_top=8, family="tiled", splits=splits)
    assert all(torch.equal(a, b) for a, b in zip(tiled, forced))


def test_fb_tiled_refuses_bad_tiles(cuda):
    words = torch.zeros((16, 384), dtype=torch.int32, device=cuda)
    dl = torch.zeros((2, 16 * 32), device=cuda)
    with pytest.raises(ValueError, match="k_tile"):
        fbk.fb_max_tiled(dl, words, 300, 128)            # 3 blocks per row
    with pytest.raises(ValueError, match="k_tile"):
        fbk.fb_max_tiled(dl, words, 300, 100)            # does not cut K_pad


@pytest.mark.parametrize("G,B,K,K_real", [(5, 3, 40, 33), (9, 4, 700, 700)])
def test_dosage_kernel_matches_plain(cuda, G, B, K, K_real):
    rng = np.random.default_rng(G + K)
    alphas = torch.from_numpy(rng.uniform(0, 1, (G, 2 * B, K)).astype(np.float32)).to(cuda)
    beta = torch.from_numpy(rng.uniform(0.1, 1, (G, 2 * B, K)).astype(np.float32)).to(cuda)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (G, B, K)).astype(np.int32)).to(cuda)
    launches = gd.DOS_KERNEL.launches
    got = gd.dosage_sweep(alphas, beta, words, 2, K_real, 0.001)
    assert gd.DOS_KERNEL.launches == launches + 1
    torch.testing.assert_close(got, gd.dosage_sweep_plain(alphas, beta, words, K_real, 0.001),
                               rtol=0, atol=1e-5)


def test_quilt2_engine_on_gpu(cuda):
    from quilt_tpu_torch.engine.driver import ImputeConfig, quilt_impute

    world = make_world(np.random.default_rng(6), K=120, nSNPs=640, n_samples=3,
                       coverage=1.5, rare_frac=0.1, quilt2=True)
    kernels = [gs.FWD_KERNEL, gs.BWD_KERNEL, gd.DOS_KERNEL]
    for k in kernels:
        k.launches = 0
    truth_gen = np.stack([t.sum(0) for t in world["truths"]], 1).astype(float)
    out = quilt_impute(world["prep"], world["samples"], ["a", "b", "c"],
                       ImputeConfig(nGibbsSamples=3, n_seek_its=2, Ksubset=48, Knew=48,
                                    small_ref_panel_gibbs_iterations=8, seed=3,
                                    use_mspbwt=True, impute_rare_common=True),
                       "cuda", truth_gen=truth_gen)
    assert min(out.r2_per_sample) > 0.85, out.r2_per_sample
    assert all(k.launches > 0 for k in kernels), [k.launches for k in kernels]


def test_engine_on_gpu(cuda):
    from quilt_tpu_torch.engine.driver import ImputeConfig, quilt_impute

    world = make_world(np.random.default_rng(5), K=120, nSNPs=640, n_samples=3,
                       coverage=1.5)
    kernels = [gs.FWD_KERNEL, gs.BWD_KERNEL, fbk.FWD_KERNEL, fbk.BWD_KERNEL]
    for k in kernels:
        k.launches = 0
    truth_gen = np.stack([t.sum(0) for t in world["truths"]], 1).astype(float)
    out = quilt_impute(world["prep"], world["samples"], ["a", "b", "c"],
                       ImputeConfig(nGibbsSamples=3, n_seek_its=2, Ksubset=48, Knew=48,
                                    small_ref_panel_gibbs_iterations=8, seed=3),
                       "cuda", truth_gen=truth_gen)
    assert min(out.r2_per_sample) > 0.9, out.r2_per_sample
    assert all(k.launches > 0 for k in kernels), [k.launches for k in kernels]


def test_engine_on_gpu_with_the_tiled_fb(cuda):
    """The large-panel path at a small size: the FB plan forced to the
    K-split family launches its four kernels and no fused one."""
    from quilt_tpu_torch.engine.driver import ImputeConfig, _region_context, quilt_impute

    world = make_world(np.random.default_rng(5), K=300, nSNPs=640, n_samples=2, coverage=1.5)
    cfg = ImputeConfig(nGibbsSamples=3, n_seek_its=2, Ksubset=48, Knew=48,
                       small_ref_panel_gibbs_iterations=8, seed=3)
    _region_context(world["prep"], cfg, "cuda").fb_plan_args = dict(family="tiled", splits=2)
    tiled = [fbk.MAX_TILED_KERNEL, fbk.FWD_TILED_KERNEL, fbk.REMAT_TILED_KERNEL,
             fbk.BWD_TILED_KERNEL]
    for k in tiled + [fbk.FWD_KERNEL, fbk.BWD_KERNEL]:
        k.launches = 0
    truth_gen = np.stack([t.sum(0) for t in world["truths"]], 1).astype(float)
    out = quilt_impute(world["prep"], world["samples"], ["a", "b"], cfg, "cuda",
                       truth_gen=truth_gen)
    assert min(out.r2_per_sample) > 0.9, out.r2_per_sample
    assert all(k.launches > 0 for k in tiled), [k.launches for k in tiled]
    assert fbk.FWD_KERNEL.launches == 0 and fbk.BWD_KERNEL.launches == 0
