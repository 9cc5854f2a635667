"""The port's CUDA kernels against their plain versions, and the engine on
the GPU (QUILT1 and QUILT2), at small shapes that reach the kernels' edge
cases (fewer haplotypes than threads, padded haplotypes, more than 64
reads in a grid, the iterative-init modes). They need an NVIDIA GPU and
nvcc and skip elsewhere; on the GPU machine, which has no jax, run them
with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: as chip_smoke.py states them (labels > 0.995 with the state
compared on chains whose labels all agree at rtol 1e-4 / atol 1e-3; beta
rtol 1e-5; FB dosage and top-K atol 1e-4; Gibbs dosages atol 1e-5)."""
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


@pytest.mark.parametrize("it_mode,G,B,W,K,K_real,max_reads", [
    (0, 9, 3, 6, 40, 36, 6),
    (1, 9, 3, 6, 40, 36, 6),
    (2, 9, 3, 6, 40, 36, 6),
    (2, 4, 2, 96, 300, 290, 90),
])
def test_sweep_kernels_match_plain(cuda, it_mode, G, B, W, K, K_real, max_reads):
    rng = np.random.default_rng(100 + it_mode + W)
    args = [torch.from_numpy(x).to(cuda)
            for x in random_sweep_state(rng, G, B, W, K, K_real, max_reads)]
    for want_alpha in (True, False):
        got = gs.fwd_sweep(*args, nl=2, K_real=K_real, it_mode=it_mode,
                           prior=(0.5, 0.5), want_alpha=want_alpha)
        ref = gs.fwd_sweep_plain(*args, K_real=K_real, it_mode=it_mode,
                                 want_alpha=want_alpha)
        live = args[3][:, 2] == 0
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
            torch.testing.assert_close(got[1][:, rows], ref[1][:, rows], rtol=1e-4, atol=1e-6)
    beta = gs.bwd_sweep(args[0], args[6], nl=2, K_real=K_real)
    torch.testing.assert_close(beta, gs.bwd_sweep_plain(args[0], args[6], K_real),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("K,B", [(90, 5), (700, 3)])
def test_fb_kernels_match_plain(cuda, K, B):
    from quilt_tpu_torch.inputs import FBInputs, thinned_grids
    from quilt_tpu.panel.prepare import trans_rates

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
