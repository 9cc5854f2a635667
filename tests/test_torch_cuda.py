"""The port's CUDA kernels against their plain versions, and the engine on
the GPU (QUILT1 and QUILT2), at small shapes that reach the kernels' edge
cases (fewer haplotypes than threads, padded haplotypes, more than 64
reads in a grid, the iterative-init modes), for both samplers (NL = 2
diploid, NL = 3 NIPT). They need an NVIDIA GPU and
nvcc and skip elsewhere; on the GPU machine, which has no jax, run them
with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: as chip_smoke.py states them (labels > 0.995 with the state
compared on chains whose labels all agree at rtol 1e-4 / atol 1e-3; beta
rtol 1e-5; FB dosage and top-K atol 1e-4; Gibbs dosages atol 1e-5; the
K-split FB: emission maxima within kernels.fb.max_tiled_tolerance (the
previous form exact), checkpoints and S rtol 1e-5, the backward's rebuilt
alphas equal to the forward's, dosage and top-K atol 1e-4; the sharded
FB's segment kernels: rtol 1e-4 plus 1e-6 of the largest, the rebuilt
alphas equal to the forward's). The cluster
forms of the two sweeps and of the NIPT bank (one chain, or a backward state
row, on a thread-block cluster) are held to the same tolerances from the
shared-memory forms' limits to their capacity, and the global forms (any K)
just past that."""
import numpy as np
import pytest
import torch

from quilt_tpu_torch.kernels import fb as fbk
from quilt_tpu_torch.kernels import gibbs_dosage as gd
from quilt_tpu_torch.kernels import gibbs_sweep as gs
from quilt_tpu_torch.kernels import nipt_bank as nb
from quilt_tpu_torch.simulate import make_world, random_sweep_state

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _sweep_variants(K, nl=2):
    """The kernel variants that hold K: the default, each explicit thread
    count as far as instantiated (64 threads at NL = 2 only), and the
    general (local-array) variant."""
    caps = ((64, 640 if nl == 2 else 0), (128, 1024), (256, 2048))
    return [None, -1] + [t for t, cap in caps if K <= cap]


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


@pytest.mark.parametrize("it_mode,G,B,W,K,K_real,max_reads,p_skip,dead_grid,prior", [
    (0, 9, 3, 6, 40, 36, 6, 0.05, None, (0.5, 0.4, 0.1)),
    (1, 9, 3, 6, 40, 36, 6, 0.05, None, (0.5, 0.4, 0.1)),
    (2, 9, 3, 6, 41, 37, 6, 0.05, None, (0.5, 0.45, 0.05)),     # K no multiple of 4
    (0, 9, 3, 6, 40, 36, 6, 0.5, 4, (0.5, 0.5, 0.0)),           # ff = 0: label 2 never drawn
    (2, 5, 2, 40, 640, 600, 35, 0.3, 2, (0.5, 0.4, 0.1)),       # the main path's K
    (2, 4, 2, 6, 1000, 990, 6, 0.05, None, (0.5, 0.4, 0.1)),    # 8 columns a thread
    (1, 4, 2, 6, 2048, 2000, 6, 0.05, None, (0.5, 0.4, 0.1)),   # the 256-thread pair's limit
    (2, 4, 2, 6, 2100, 2050, 6, 0.05, None, (0.5, 0.4, 0.1)),   # the general variant
    (1, 4, 2, 3, 8100, 8090, 3, 0.05, 2, (0.5, 0.4, 0.1)),      # the rings shrunk to one stage each
])
def test_sweep_kernels_match_plain_nipt(cuda, it_mode, G, B, W, K, K_real, max_reads, p_skip,
                                        dead_grid, prior):
    rng = np.random.default_rng(200 + it_mode + W)
    state = list(random_sweep_state(rng, G, B, W, K, K_real, max_reads, p_skip, nl=3))
    if dead_grid is not None:
        state[3][dead_grid, 2] = 1
    args = [torch.from_numpy(x).to(cuda) for x in state]
    live = args[3][:, 2] == 0
    kw = dict(nl=3, K_real=K_real, it_mode=it_mode, prior=prior)
    ref = gs.fwd_sweep_plain(*args, K_real=K_real, it_mode=it_mode, nl=3, prior=prior)
    forms = [dict(_variant=v) for v in _sweep_variants(K, 3)]
    if 512 < K <= 640:       # the one-reduction form of a step, where it is built
        forms.append(dict(_wide=True))
    launches = gs.FWD_KERNELS[3].launches, gs.FWD_KERNELS[2].launches
    for form in forms:
        got = gs.fwd_sweep(*args, **form, **kw)
        assert (got[2][live] == ref[2][live]).float().mean().item() > 0.995
        assert torch.equal(got[2][~live], ref[2][~live])
        if prior[2] == 0.0:
            assert not (got[2][live & (got[2] != args[3][:, 1])] == 2).any()
        same = ((got[2] == ref[2]) | ~live).all(0).all(0)
        rows = torch.cat([same] * 3)
        assert same.any()
        torch.testing.assert_close(got[0][:, rows], ref[0][:, rows], rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(got[1][:, rows], ref[1][:, rows], rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(got[3][rows], ref[3][rows], rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(got[5][same], ref[5][same], rtol=0, atol=0)
        assert torch.equal(got[4], ref[4])
    assert gs.FWD_KERNELS[3].launches == launches[0] + len(forms)
    assert gs.FWD_KERNELS[2].launches == launches[1]
    ref_b = gs.bwd_sweep_plain(args[0], args[6], K_real)
    for variant in _sweep_variants(K):                       # 3B state rows: an odd count
        beta = gs.bwd_sweep(args[0], args[6], nl=3, K_real=K_real, _variant=variant)
        torch.testing.assert_close(beta, ref_b, rtol=1e-5, atol=1e-6)


def test_sweep_kernels_refuse_a_variant_that_does_not_hold_k(cuda):
    """An explicit thread count never gives way to another variant."""
    args = [torch.from_numpy(x).to(cuda) for x in random_sweep_state(
        np.random.default_rng(1), 2, 1, 2, 700, 700, 2)]
    with pytest.raises(RuntimeError, match="gibbs_fwd"):
        gs.fwd_sweep(*args, nl=2, K_real=700, it_mode=2, prior=(0.5, 0.5), _variant=64)
    with pytest.raises(RuntimeError, match="gibbs_bwd"):
        gs.bwd_sweep(args[0], args[6], nl=2, K_real=700, _variant=64)
    # the forms built for one shape only: NL = 3 has no 64-thread pair, and
    # its one-reduction form exists for K in (512, 640]
    args3 = [torch.from_numpy(x).to(cuda) for x in random_sweep_state(
        np.random.default_rng(1), 2, 1, 2, 700, 700, 2, nl=3)]
    for form in (dict(_variant=64), dict(_wide=True)):
        with pytest.raises(RuntimeError, match="gibbs_fwd"):
            gs.fwd_sweep(*args3, nl=3, K_real=700, it_mode=2, prior=(0.5, 0.4, 0.1), **form)
    # the general variant where it does not hold K: above its 10,240 columns,
    # and at NL = 3 where one grid stage (6 rows) and a read row outgrow
    # shared memory
    for nl, K in ((2, 10368), (3, 9000)):
        big = [torch.from_numpy(x).to(cuda) for x in random_sweep_state(
            np.random.default_rng(1), 2, 1, 2, K, K, 2, nl=nl)]
        prior = (0.5, 0.5) if nl == 2 else (0.5, 0.4, 0.1)
        with pytest.raises(RuntimeError, match="gibbs_fwd"):
            gs.fwd_sweep(*big, nl=nl, K_real=K, it_mode=2, prior=prior, _variant=-1)
    with pytest.raises(RuntimeError, match="gibbs_bwd"):
        gs.bwd_sweep(torch.zeros((2, 2, 10368), device=cuda), big[6], nl=2, K_real=10368,
                     _variant=-1)
    # the cluster form past its capacity: refused, never replaced
    for nl, K in ((2, 16512), (3, 12416)):
        big = [torch.from_numpy(x).to(cuda) for x in random_sweep_state(
            np.random.default_rng(1), 2, 1, 2, K, K, 2, nl=nl)]
        prior = (0.5, 0.5) if nl == 2 else (0.5, 0.4, 0.1)
        with pytest.raises(RuntimeError, match="gibbs_fwd"):
            gs.fwd_sweep(*big, nl=nl, K_real=K, it_mode=2, prior=prior, _variant=gs.CLUSTER)


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


@pytest.mark.parametrize("K,B,g", [(90, 5, 0), (700, 14, 17), (700, 3, 34)])
def test_fb_backward_capture_matches_plain(cuda, K, B, g):
    """fb_backward with the capture flag at grid g against its plain version
    (gcap atol 1e-5, each row a distribution within 1e-5, zero at padded
    haplotypes); dosage and top-K equal those of the call without capture;
    the capturing launch is counted apart; through fb_full_batched the
    fifth output is gcap[:, :K]."""
    from quilt_tpu_torch.inputs import FBInputs, thinned_grids
    from quilt_tpu_torch.panel.prepare import trans_rates

    world = make_world(np.random.default_rng(K), K=K, nSNPs=1100, n_samples=1)
    prep = world["prep"]
    fb = FBInputs.build(prep.panel, trans_rates(prep.sigma),
                        thinned_grids=thinned_grids(prep.nGrids, 0.3), capture_grid=g)
    dev = fb.device_tensors(cuda)
    words, trans2, thin, cap = dev["words"], dev["trans2"], dev["thin_flag"], dev["capture_flag"]
    gen = torch.Generator(device=cuda).manual_seed(K + g)
    gl = 0.05 + 0.95 * torch.rand((B, 2, fb.S), generator=gen, device=cuda)
    dl, _ = fbk._gl_log_ratios(gl, 0.001)
    ck, _ = fbk.fb_forward(dl, words, trans2, K)
    fbk.BWD_KERNEL.launches = fbk.BWD_CAPTURE_KERNEL.launches = 0
    got = fbk.fb_backward(dl, words, ck, trans2, thin, K, 8, 0.001, cap=cap)
    plain = fbk.fb_backward(dl, words, ck, trans2, thin, K, 8, 0.001)
    assert (fbk.BWD_KERNEL.launches, fbk.BWD_CAPTURE_KERNEL.launches) == (1, 1)
    ref = fbk.fb_backward_plain(dl, words, ck, trans2, thin, K, 8, 0.001, cap=cap)
    torch.testing.assert_close(got[3], ref[3], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[3].sum(1), torch.ones(B, device=cuda), rtol=0, atol=1e-5)
    assert not got[3][:, K:].any()
    for a, b in zip(got[:3], plain):
        assert torch.equal(a, b)
    out = fbk.fb_full_batched(gl, fb, K_top=8)
    torch.testing.assert_close(out[4], got[3][:, :K], rtol=0, atol=1e-6)


def _random_fb(K, nGrids, seed, capture_grid=-1):
    """FB inputs of a random panel (random words, 2% jump rate, every tenth
    grid thinned, K_pad = K rounded up to 128), as chip_smoke.synthetic_fb."""
    from quilt_tpu_torch.inputs import FBInputs

    rng = np.random.default_rng(seed)
    K_pad = -(-K // 128) * 128
    words = np.zeros((nGrids, K_pad), dtype=np.int32)
    words[:, :K] = rng.integers(-2**31, 2**31, (nGrids, K), dtype=np.int64).astype(np.int32)
    trans = np.tile(np.float32([0.98, 0.02]), (nGrids, 1))
    trans[0] = (1.0, 1.0)
    thin = np.full(nGrids, -1, dtype=np.int32)
    thin[::10] = np.arange(len(thin[::10]))
    return FBInputs(words=words, trans=trans, thin_flag=thin, K=K, K_pad=K_pad, nGrids=nGrids,
                    S=nGrids * 32, nSNPs=nGrids * 32, capture_grid=capture_grid)


@pytest.mark.parametrize("K,B,capture,general", [
    (90, 1, False, False), (90, 14, True, False),    # 1 haplotype a thread
    (700, 14, False, False), (700, 112, True, False),  # 2
    (700, 14, True, True),                           # the general form, alphas in shared memory
    (2000, 14, True, False), (4000, 14, False, False),  # 4, 8
    (5120, 1, True, False), (5120, 14, False, False), (5120, 112, True, False),  # 10
    (8000, 14, True, False), (8000, 112, False, False),  # 16, checkpoint interval 4
    (14000, 14, True, False),                        # K_pad 14,080: alphas in global planes
])
def test_fb_redesigned_kernels_match_plain(cuda, K, B, capture, general):
    """The fused forward and backward at their checkpoint interval
    (fused_cg) against their plain versions: checkpoints atol 1e-5,
    log-likelihood rtol 1e-5 + atol 1e-2, dosage and top-K values atol 1e-4
    with indices equal where the gap is over 1e-3, gcap atol 1e-5 (the
    capture at the global last grid, the beta = 1 step); two launches give
    the same bits."""
    nG = 64
    fb = _random_fb(K, nG, K + B, capture_grid=nG - 1 if capture else -1)
    dev = fb.device_tensors(cuda)
    words, trans2, thin = dev["words"], dev["trans2"], dev["thin_flag"]
    cap = dev["capture_flag"] if capture else None
    gen = torch.Generator(device=cuda).manual_seed(K + B)
    gl = 0.05 + 0.95 * torch.rand((B, 2, fb.S), generator=gen, device=cuda)
    dl, _ = fbk._gl_log_ratios(gl, 0.001)
    smem, cpt = fbk._bwd_storage(fbk.fused_cg(fb.K_pad, nG), fb.K_pad, 8, general)
    assert smem == (K < 14000) and (cpt == 0) == (K == 14000 or general)
    ck, lg = fbk.fb_forward(dl, words, trans2, K, _general=general)
    ck_r, lg_r = fbk.fb_forward_plain(dl, words, trans2, K)
    torch.testing.assert_close(ck, ck_r, rtol=0, atol=1e-5)
    torch.testing.assert_close(lg, lg_r, rtol=1e-5, atol=1e-2)
    got = fbk.fb_backward(dl, words, ck, trans2, thin, K, 8, 0.001, cap=cap, _general=general)
    again = fbk.fb_backward(dl, words, ck, trans2, thin, K, 8, 0.001, cap=cap, _general=general)
    ref = fbk.fb_backward_plain(dl, words, ck, trans2, thin, K, 8, 0.001, cap=cap)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-4)
    g = thin >= 0
    firm = (ref[1][g][:, :, :-1] - ref[1][g][:, :, 1:]) > 1e-3
    assert torch.equal(got[2][g][:, :, :-1][firm], ref[2][g][:, :, :-1][firm])
    if capture:
        torch.testing.assert_close(got[3], ref[3], rtol=0, atol=1e-5)
        assert not got[3][:, K:].any()


def test_fb_kernels_refuse_columns_without_an_instantiation(cuda):
    """The entry points take the wrapper's register columns a thread and
    refuse a count that does not hold K_pad or has no instantiation."""
    K_pad, Gp, B, CG = 1024, 16, 2, 8
    words = torch.zeros((Gp, K_pad), dtype=torch.int32, device=cuda)
    dl = torch.zeros((B, Gp * 32), dtype=torch.float32, device=cuda)
    trans2 = torch.ones((2, Gp), dtype=torch.float32, device=cuda)
    ckpt = torch.empty((Gp // CG, B, K_pad), dtype=torch.float32, device=cuda)
    logs = torch.empty((B,), dtype=torch.float32, device=cuda)
    for cpt in (1, 3):                       # 512 columns < K_pad; no instantiation
        with pytest.raises(RuntimeError, match="cudaError"):
            fbk.FWD_KERNEL.launch(words.data_ptr(), dl.data_ptr(), trans2.data_ptr(),
                                  ckpt.data_ptr(), logs.data_ptr(), None, Gp, K_pad, K_pad,
                                  B, CG, 1.0 / K_pad, cpt)


def test_fb_previous_form_matches_the_redesign(cuda):
    """The previous fused kernels, kept for timing beside the redesign, give
    the same FB (dosage atol 1e-4) at their own checkpoint interval of 16."""
    fb = _random_fb(5120, 64, 3)
    dev = fb.device_tensors(cuda)
    words, trans2, thin = dev["words"], dev["trans2"], dev["thin_flag"]
    gen = torch.Generator(device=cuda).manual_seed(3)
    gl = 0.05 + 0.95 * torch.rand((14, 2, fb.S), generator=gen, device=cuda)
    dl, _ = fbk._gl_log_ratios(gl, 0.001)
    launches = fbk.FWD_KERNEL.launches, fbk.BWD_KERNEL.launches
    ck16, lg16 = fbk.fb_forward(dl, words, trans2, fb.K, 16, _prev=True)
    old = fbk.fb_backward(dl, words, ck16, trans2, thin, fb.K, 8, 0.001, 16, _prev=True)
    assert (fbk.FWD_KERNEL.launches, fbk.BWD_KERNEL.launches) == launches
    ck, lg = fbk.fb_forward(dl, words, trans2, fb.K)
    new = fbk.fb_backward(dl, words, ck, trans2, thin, fb.K, 8, 0.001)
    torch.testing.assert_close(lg, lg16, rtol=1e-5, atol=1e-2)
    torch.testing.assert_close(new[0], old[0], rtol=0, atol=1e-4)


def test_fb_chain_floor_runs(cuda):
    for which in (0, 1):
        out = fbk.chain_floor(100, 2, which, cuda)
        torch.cuda.synchronize()
        assert out.shape == (2,) and torch.isfinite(out).all()


@pytest.mark.parametrize("K,B,splits", [(90, 5, 2), (700, 3, 8), (700, 3, 1), (3000, 2, 4)])
def test_fb_tiled_kernels_match_plain(cuda, K, B, splits):
    """Each K-split kernel against its plain version, the whole tiled FB
    against the fused CUDA FB, launch counts (one launch of each kernel an
    FB call), and run-to-run equality."""
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
    kernels = [fbk.MAX_TILED_KERNEL, fbk.FWD_TILED_KERNEL, fbk.BWD_TILED_KERNEL,
               fbk._PREV_REMAT_TILED, fbk._PREV_BWD_TILED, fbk._PREV_FWD_TILED]
    for k in kernels:
        k.launches = 0
    mx = fbk.fb_max_tiled(dl, words, K, kt)
    mx_r = fbk.fb_max_tiled_plain(dl, words, K, kt)
    assert ((mx - mx_r).abs() <= fbk.max_tiled_tolerance(dl, fb.nGrids)).all()
    ck, S, lg = fbk.fb_forward_tiled(dl, words, trans2, mx, K, kt)
    ck_r, S_r, lg_r = fbk.fb_forward_tiled_plain(dl, words, trans2, mx, K, kt)
    torch.testing.assert_close(ck, ck_r, rtol=1e-5, atol=1e-30)
    torch.testing.assert_close(S, S_r, rtol=1e-5, atol=0)
    torch.testing.assert_close(lg, lg_r, rtol=1e-5, atol=1e-2)
    got = fbk.fb_backward_tiled(dl, words, ck, trans2, thin, mx, S, K, 8, 0.001, kt)
    ref = fbk.fb_backward_tiled_plain(dl, words, ck, trans2, thin, mx, S, K, 8, 0.001, kt)
    _assert_tiled_backward(got, ref, thin)
    assert [k.launches for k in kernels] == [1, 1, 1, 0, 0, 0]
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
    assert [k.launches for k in kernels] == [4, 4, 4, 0, 0, 0]


def _assert_tiled_backward(got, ref, thin):
    """Dosage and top-K values atol 1e-4, indices equal where the plain
    version's neighbouring values differ by more than 1e-3, zeros away from
    the thinned grids."""
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-4)
    g = thin >= 0
    firm = (ref[1][g][:, :, :-1] - ref[1][g][:, :, 1:]) > 1e-3
    assert torch.equal(got[2][g][:, :, :-1][firm], ref[2][g][:, :, :-1][firm])
    assert not got[1][~g].any() and not got[2][~g].any()


@pytest.mark.parametrize("K,splits", [
    (2000, 2), (2000, 4), (2000, 8),          # ragged: K_pad 2,048; 2 haplotypes a thread
    (13500, 2), (13500, 4), (13500, 8),       # 16, 8, 4 a thread
    (40960, 2), (40960, 4), (40960, 8),       # general form (shared planes), 20, 16
    (60000, 2),                               # 30,016 a block: alpha planes in global memory
])
def test_fb_tiled_backward_matches_plain(cuda, K, splits):
    """The one-launch tiled backward against fb_backward_tiled_plain at
    K_top 1, 8, 16 and 32, with its checkpoint interval tiled_cg and every
    storage form it has; two launches give the same bits; the rebuilt
    alphas equal the forward's bit for bit (the forward's alpha entering
    grid g + 1, read from its checkpoints at interval 1)."""
    nG, B = 64, 3
    fb = _random_fb(K, nG, K + splits)
    dev = fb.device_tensors(cuda)
    words, trans2, thin = dev["words"], dev["trans2"], dev["thin_flag"]
    gen = torch.Generator(device=cuda).manual_seed(K + splits)
    gl = 0.05 + 0.95 * torch.rand((B, 2, fb.S), generator=gen, device=cuda)
    dl, _ = fbk._gl_log_ratios(gl, 0.001)
    kt = fb.K_pad // splits
    CG = fbk.tiled_cg(kt, nG)
    smem, cpt = fbk._tiled_storage(CG, kt, 32)
    assert smem == (kt <= 27552) and (cpt == 0) == (kt > 24 * 512)
    mx = fbk.fb_max_tiled(dl, words, K, kt)
    ck, S, _ = fbk.fb_forward_tiled(dl, words, trans2, mx, K, kt)
    for K_top in (1, 8, 16, 32):
        args = (dl, words, ck, trans2, thin, mx, S, K, K_top, 0.001, kt)
        got = fbk.fb_backward_tiled(*args)
        _assert_tiled_backward(got, fbk.fb_backward_tiled_plain(*args), thin)
        again = fbk.fb_backward_tiled(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    rebuilt = torch.zeros((nG, B, fb.K_pad), device=cuda)
    fbk.fb_backward_tiled(dl, words, ck, trans2, thin, mx, S, K, 8, 0.001, kt, _rebuilt=rebuilt)
    ck1, S1, _ = fbk.fb_forward_tiled(dl, words, trans2, mx, K, kt, CG=1)
    assert torch.equal(S1, S)
    assert torch.equal(rebuilt[:-1], ck1[1:])


@pytest.mark.parametrize("K,splits", [
    (2000, 1), (2000, 2), (2000, 4), (2000, 8),         # ragged: K_pad 2,048
    (13500, 1), (13500, 2), (13500, 4), (13500, 8),     # ragged: K_pad 13,568
    (40960, 1), (40960, 2), (40960, 4), (40960, 8),
])
def test_fb_tiled_forward_matches_plain(cuda, K, splits):
    """The tiled forward against fb_forward_tiled_plain at each checkpoint
    interval (2, 4, 8, 16), in its general form and, where 20 haplotypes a
    thread hold the block, its register form: checkpoints rtol 1e-5, S rtol
    1e-6, log-likelihood atol 1e-3; the pad haplotypes' checkpoints 0; two
    launches, and the two forms, equal bit for bit; the previous form
    (timings only) agrees."""
    nG, B = 32, 3
    fb = _random_fb(K, nG, K + 7 * splits)
    dev = fb.device_tensors(cuda)
    words, trans2 = dev["words"], dev["trans2"]
    gen = torch.Generator(device=cuda).manual_seed(K + splits)
    gl = 0.05 + 0.95 * torch.rand((B, 2, fb.S), generator=gen, device=cuda)
    dl, _ = fbk._gl_log_ratios(gl, 0.001)
    kt = fb.K_pad // splits
    mx = fbk.fb_max_tiled(dl, words, K, kt)
    ck_r, S_r, lg_r = fbk.fb_forward_tiled_plain(dl, words, trans2, mx, K, kt, CG=1)
    cpt = fbk._fwd_tiled_cpt(kt)
    assert (cpt == 0) == (kt > 24 * 512)
    forms = [dict(_general=True)] + ([{}] if cpt else [])
    for CG in (2, 4, 8, 16):
        first = None
        for form in forms + [dict(_prev=True)]:
            got = fbk.fb_forward_tiled(dl, words, trans2, mx, K, kt, CG, **form)
            ck, S, lg = got
            torch.testing.assert_close(ck, ck_r[::CG], rtol=1e-5, atol=1e-30)
            torch.testing.assert_close(S, S_r, rtol=1e-6, atol=0)
            torch.testing.assert_close(lg, lg_r, rtol=0, atol=1e-3)
            if form.get("_prev"):
                continue
            assert not ck[..., K:].any()
            again = fbk.fb_forward_tiled(dl, words, trans2, mx, K, kt, CG, **form)
            assert all(torch.equal(a, b) for a, b in zip(got, again)), form
            first = first or got
            assert all(torch.equal(a, b) for a, b in zip(got, first)), form


def test_fb_tiled_forward_refuses_what_it_has_no_instantiation_for(cuda):
    """Register columns too few for the block or without an instantiation,
    and an interval above 16 raise; nothing falls back to the general form
    or the plain version."""
    fb = _random_fb(4096, 32, 2)
    dev = fb.device_tensors(cuda)
    words, trans2 = dev["words"], dev["trans2"]
    B, Gp, K_pad = 2, 32, fb.K_pad
    dl = torch.zeros((B, Gp * 32), device=cuda)
    mx = torch.zeros((Gp, B), device=cuda)
    out = torch.empty((B, Gp * K_pad), device=cuda)
    for CG, cpt in ((16, 2),                     # 1,024 < 2,048 haplotypes a block
                    (16, 3), (16, 12), (32, 4)):
        with pytest.raises(RuntimeError, match="cudaError"):
            fbk.FWD_TILED_KERNEL.launch(words.data_ptr(), dl.data_ptr(), trans2.data_ptr(),
                                        mx.data_ptr(), out.data_ptr(), out.data_ptr(),
                                        out.data_ptr(), out.data_ptr(), Gp, fb.K, K_pad, B, CG,
                                        2, 1.0 / fb.K, cpt)


def test_fb_tiled_forward_floor_runs(cuda):
    for fwd in (False, True):
        out = fbk.tiled_chain_floor(100, 2, 4, cuda, fwd=fwd)
        torch.cuda.synchronize()
        assert out.shape == (2, 4) and torch.isfinite(out).all()


def test_fb_tiled_general_form_matches_the_register_form(cuda):
    """The general form (e*beta in a global plane, words read in the step)
    forced at a width the register form holds: the same FB to rounding."""
    fb = _random_fb(13500, 64, 5)
    dev = fb.device_tensors(cuda)
    words, trans2, thin = dev["words"], dev["trans2"], dev["thin_flag"]
    gen = torch.Generator(device=cuda).manual_seed(5)
    gl = 0.05 + 0.95 * torch.rand((3, 2, fb.S), generator=gen, device=cuda)
    dl, _ = fbk._gl_log_ratios(gl, 0.001)
    kt = fb.K_pad // 4
    mx = fbk.fb_max_tiled(dl, words, fb.K, kt)
    ck, S, _ = fbk.fb_forward_tiled(dl, words, trans2, mx, fb.K, kt)
    args = (dl, words, ck, trans2, thin, mx, S, fb.K, 8, 0.001, kt)
    _assert_tiled_backward(fbk.fb_backward_tiled(*args, _general=True),
                           fbk.fb_backward_tiled(*args), thin)


def test_fb_tiled_previous_form_matches_the_redesign(cuda):
    """The previous tiled backward (a remat and a backward launch per chunk
    of 16 grids), kept for timing beside the redesign, gives the same FB
    (dosage and top-K atol 1e-4) with its own launch counts."""
    fb = _random_fb(40960, 64, 9)
    dev = fb.device_tensors(cuda)
    words, trans2, thin = dev["words"], dev["trans2"], dev["thin_flag"]
    gen = torch.Generator(device=cuda).manual_seed(9)
    gl = 0.05 + 0.95 * torch.rand((4, 2, fb.S), generator=gen, device=cuda)
    dl, _ = fbk._gl_log_ratios(gl, 0.001)
    kt = fb.K_pad // 4
    mx = fbk.fb_max_tiled(dl, words, fb.K, kt)
    ck16, S, _ = fbk.fb_forward_tiled(dl, words, trans2, mx, fb.K, kt, CG=16)
    ck, _, _ = fbk.fb_forward_tiled(dl, words, trans2, mx, fb.K, kt)
    launches = fbk.BWD_TILED_KERNEL.launches, fbk._PREV_REMAT_TILED.launches
    old = fbk.fb_backward_tiled(dl, words, ck16, trans2, thin, mx, S, fb.K, 8, 0.001, kt, 16,
                                _prev=True)
    assert fbk.BWD_TILED_KERNEL.launches == launches[0]
    assert fbk._PREV_REMAT_TILED.launches == launches[1] + 64 // 16
    new = fbk.fb_backward_tiled(dl, words, ck, trans2, thin, mx, S, fb.K, 8, 0.001, kt)
    _assert_tiled_backward(old, new, thin)


def test_fb_tiled_refuses_bad_tiles(cuda):
    words = torch.zeros((16, 384), dtype=torch.int32, device=cuda)
    dl = torch.zeros((2, 16 * 32), device=cuda)
    with pytest.raises(ValueError, match="k_tile"):
        fbk.fb_max_tiled(dl, words, 300, 128)            # 3 blocks per row
    with pytest.raises(ValueError, match="k_tile"):
        fbk.fb_max_tiled(dl, words, 300, 100)            # does not cut K_pad
    words = torch.zeros((16, 4096), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="k_tile"):
        fbk.fb_max_tiled(dl, words, 4000, 128)           # 32 blocks per row


@pytest.mark.parametrize("K,splits", [
    (12000, 1),                 # the staged form, one block a row, ragged (K_pad 12,032)
    (24576, 2),                 # the staged form at its widest block, 12,288
    (98304, 8),                 # K = 98,304 at 8 blocks a row: the staged form
    (98304, 16),                # and at 16: 6,144 a block, 16 haplotypes a thread
    (40960, 16),                # 16 blocks of 2,560 (8 a thread)
    (194512, 16),               # a TOPMed-sized panel (K_pad 194,560): 12,160 a block,
                                # the last block ragged
])
def test_fb_tiled_staged_and_16_block_forms_match_plain(cuda, K, splits):
    """The staged form (24 haplotypes a thread: the forward's next words,
    the backward's word planes in shared memory, checkpoint interval 2) and
    clusters of 16 blocks against the plain versions: checkpoints and S
    rtol 1e-5, log-likelihood atol 1e-3, the backward at K_top 1, 8 and 32
    (dosage and top-K atol 1e-4, indices where the values settle them);
    two launches equal bit for bit; the rebuilt alphas equal the
    forward's."""
    nG, B = 32, 3
    fb = _random_fb(K, nG, K + splits)
    dev = fb.device_tensors(cuda)
    words, trans2, thin = dev["words"], dev["trans2"], dev["thin_flag"]
    gen = torch.Generator(device=cuda).manual_seed(K + splits)
    gl = 0.05 + 0.95 * torch.rand((B, 2, fb.S), generator=gen, device=cuda)
    dl, _ = fbk._gl_log_ratios(gl, 0.001)
    kt = fb.K_pad // splits
    CG = fbk.tiled_cg(kt, nG)
    smem, cpt = fbk._tiled_storage(CG, kt, 32)
    staged = 20 * 512 < kt <= 24 * 512
    assert smem and cpt and cpt == fbk._fwd_tiled_cpt(kt) and (cpt == 24) == staged
    assert (CG == 2) if staged else (CG > 2)
    mx = fbk.fb_max_tiled(dl, words, K, kt)
    ck_r, S_r, lg_r = fbk.fb_forward_tiled_plain(dl, words, trans2, mx, K, kt, CG=1)
    ck, S, lg = got = fbk.fb_forward_tiled(dl, words, trans2, mx, K, kt)
    torch.testing.assert_close(ck, ck_r[::CG], rtol=1e-5, atol=1e-30)
    torch.testing.assert_close(S, S_r, rtol=1e-5, atol=0)
    torch.testing.assert_close(lg, lg_r, rtol=0, atol=1e-3)
    assert not ck[..., K:].any()
    again = fbk.fb_forward_tiled(dl, words, trans2, mx, K, kt)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for K_top in (1, 8, 32):
        args = (dl, words, ck, trans2, thin, mx, S, K, K_top, 0.001, kt)
        out = fbk.fb_backward_tiled(*args)
        _assert_tiled_backward(out, fbk.fb_backward_tiled_plain(*args), thin)
        assert all(torch.equal(a, b) for a, b in zip(out, fbk.fb_backward_tiled(*args)))
    rebuilt = torch.zeros((nG, B, fb.K_pad), device=cuda)
    fbk.fb_backward_tiled(dl, words, ck, trans2, thin, mx, S, K, 8, 0.001, kt, _rebuilt=rebuilt)
    ck1, S1, _ = fbk.fb_forward_tiled(dl, words, trans2, mx, K, kt, CG=1)
    assert torch.equal(S1, S)
    assert torch.equal(rebuilt[:-1], ck1[1:])
    tiled = fbk.fb_tiled_core(gl, words, trans2, thin, K, 8, 0.001, k_tile=kt)
    forced = fbk.fb_full_batched(gl, fb, K_top=8, family="tiled", splits=splits)
    assert all(torch.equal(a, b) for a, b in zip(tiled, forced))


def test_fb_tiled_backward_refuses_what_it_has_no_instantiation_for(cuda):
    """A split that does not cut K_pad into 1, 2, 4, 8 or 16 blocks, a K_top
    above 32, and register columns or a storage without an instantiation
    raise; nothing falls back to the plain version."""
    fb = _random_fb(4096, 16, 1)
    dev = fb.device_tensors(cuda)
    words, trans2, thin = dev["words"], dev["trans2"], dev["thin_flag"]
    B, Gp, K_pad = 2, 16, fb.K_pad
    dl = torch.zeros((B, Gp * 32), device=cuda)
    mx = torch.zeros((Gp, B), device=cuda)
    S = torch.ones((Gp, B), device=cuda)
    ck = torch.zeros((Gp // 16, B, K_pad), device=cuda)
    args = (dl, words, ck, trans2, thin, mx, S, fb.K)
    with pytest.raises(ValueError, match="k_tile"):
        fbk.fb_backward_tiled(*args, 8, 0.001, K_pad // 3 + 1, 16)
    with pytest.raises(RuntimeError, match="cudaError"):
        fbk.fb_backward_tiled(*args, 33, 0.001, K_pad // 4, 16)
    out = torch.empty((B, Gp * 32 + 2 * Gp * 33), device=cuda)
    scratch = torch.empty((B, 17, K_pad), device=cuda)
    for smem, cpt in ((1, 1), (1, 3), (1, 2), (0, 8)):   # no such columns; 1,024 < 2,048 a block
        with pytest.raises(RuntimeError, match="cudaError"):
            fbk.BWD_TILED_KERNEL.launch(
                words.data_ptr(), dl.data_ptr(), ck.data_ptr(), trans2.data_ptr(),
                thin.data_ptr(), mx.data_ptr(), S.data_ptr(), out.data_ptr(), out.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), None, Gp, fb.K, K_pad, B, 16, 8, 2,
                1.0 / fb.K, 0.001, smem, cpt)


@pytest.mark.parametrize("KS", [64, 1024, 3296, 3312, 5120, 10240, 10248, 12160, 12288, 13712,
                                27552, 30016])
def test_fb_tiled_smem_layout_matches_the_kernel(cuda, KS):
    """The wrapper's copy of the tiled backward's shared-memory layout
    (_bwd_tiled_smem_bytes, which tiled_cg and _tiled_storage read) equals
    the kernel library's (fb_tiled.cu bwd_smem_floats), so the interval and
    storage that the wrapper chooses are the ones the kernel accepts: global
    planes, the alpha planes, and the staged form's alpha and word planes."""
    for CG in (1, 2, 4, 8, 16):
        for K_top in (1, 8, 16, 32):
            for planes in (True, False, 2):
                assert (fbk.kernel_tiled_smem_bytes(CG, KS, K_top, planes)
                        == fbk._bwd_tiled_smem_bytes(CG, KS, K_top, planes))


@pytest.mark.parametrize("G,B,K,K_real,nl", [
    (5, 3, 40, 33, 2), (9, 4, 700, 700, 2), (5, 3, 41, 33, 3), (9, 4, 700, 700, 3),
    (2, 2, 5000, 4990, 3),                      # the previous form's 48 KB of shared memory
    (3, 2, 30000, 29990, 2), (2, 2, 20000, 19999, 3),   # above the previous form's limit
    (5, 3, 130, 130, 2),                        # one haplotype past a staged chunk
])
def test_dosage_kernel_matches_plain(cuda, G, B, K, K_real, nl):
    """The dosage kernel against its plain version (atol 1e-5), with an
    all-zero state row, whose dosages are 0; the previous form (timings
    only) agrees where it holds K."""
    rng = np.random.default_rng(G + K)
    alphas = rng.uniform(0, 1, (G, nl * B, K)).astype(np.float32)
    alphas[G - 1, nl * B - 1] = 0.0
    alphas = torch.from_numpy(alphas).to(cuda)
    beta = torch.from_numpy(rng.uniform(0.1, 1, (G, nl * B, K)).astype(np.float32)).to(cuda)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (G, B, K)).astype(np.int32)).to(cuda)
    launches = gd.DOS_KERNELS[nl].launches
    got = gd.dosage_sweep(alphas, beta, words, nl, K_real, 0.001)
    assert gd.DOS_KERNELS[nl].launches == launches + 1
    ref = gd.dosage_sweep_plain(alphas, beta, words, K_real, 0.001, nl)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    assert not got[G - 1, nl * B - 1].any()
    if nl * K * 4 <= 227 * 1024:
        launches = gd.DOS_KERNELS[nl].launches
        prev = gd.dosage_sweep(alphas, beta, words, nl, K_real, 0.001, _prev=True)
        assert gd.DOS_KERNELS[nl].launches == launches
        torch.testing.assert_close(prev, ref, rtol=0, atol=1e-5)


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
    K-split family launches its three kernels once an FB call each, and no
    fused kernel and no previous tiled form."""
    from quilt_tpu_torch.engine.driver import ImputeConfig, _region_context, quilt_impute

    world = make_world(np.random.default_rng(5), K=300, nSNPs=640, n_samples=2, coverage=1.5)
    cfg = ImputeConfig(nGibbsSamples=3, n_seek_its=2, Ksubset=48, Knew=48,
                       small_ref_panel_gibbs_iterations=8, seed=3)
    _region_context(world["prep"], cfg, "cuda").fb_plan_args = dict(family="tiled", splits=2)
    tiled = [fbk.MAX_TILED_KERNEL, fbk.FWD_TILED_KERNEL, fbk.BWD_TILED_KERNEL]
    prev = [fbk._PREV_REMAT_TILED, fbk._PREV_BWD_TILED, fbk._PREV_FWD_TILED]
    for k in tiled + prev + [fbk.FWD_KERNEL, fbk.BWD_KERNEL]:
        k.launches = 0
    truth_gen = np.stack([t.sum(0) for t in world["truths"]], 1).astype(float)
    out = quilt_impute(world["prep"], world["samples"], ["a", "b"], cfg, "cuda",
                       truth_gen=truth_gen)
    assert min(out.r2_per_sample) > 0.9, out.r2_per_sample
    assert all(k.launches > 0 for k in tiled), [k.launches for k in tiled]
    assert len({k.launches for k in tiled}) == 1, [k.launches for k in tiled]
    assert all(k.launches == 0 for k in prev + [fbk.FWD_KERNEL, fbk.BWD_KERNEL])


@pytest.mark.parametrize("G,B,K,K_real,p_end", [
    (9, 3, 40, 36, 0.3), (40, 5, 641, 600, 0.1), (6, 2, 3000, 2990, 1.0), (12, 2, 64, 64, 0.0),
    (512, 28, 640, 600, 12 / 512),                  # the nipt path's shape
])
def test_nipt_bank_kernel_matches_plain(cuda, G, B, K, K_real, p_end):
    """The NIPT block move's bank kernel against the Python loop, in the
    form the wrapper picks (registers up to K = 1,024, the general form at
    3,000): the same
    relabellings on all but a tenth of the chains (at most one of a few),
    probabilities atol 1e-4 on the chains whose draws agree; a block end at
    every grid, and at none but the last; two launches equal bit for bit;
    the previous form (timings only) draws the same."""
    rng = np.random.default_rng(G + K)
    lemg, beta = (torch.from_numpy(x).to(cuda) for x in random_sweep_state(
        rng, G, B, 4, K, K_real, 4, nl=3)[:2])
    trans = np.stack([rng.uniform(0.9, 0.999, G), rng.uniform(0.001, 0.1, G)]).astype(np.float32)
    trans[:, 0] = (1.0, 0.0)
    is_end = (rng.random((G, B)) < p_end).astype(np.int32)
    is_end[G - 1] = 1
    t = lambda x: torch.from_numpy(x).to(cuda)
    mask = torch.ones(6, device=cuda)
    mask[3] = 0.0                                   # a relabelling that is not allowed
    args = (lemg, beta, t(trans), t(rng.normal(0, 2, (G, B, 6)).astype(np.float32)),
            t(rng.random((G, B)).astype(np.float32)), t(is_end), mask, K_real)
    ref_c, ref_p = nb.bank_scan_plain(*args)
    for form in ({}, {"_prev": True}):
        counter = nb._PREV_BANK_KERNEL if form.get("_prev") else nb.BANK_KERNEL
        launches = counter.launches
        got_c, got_p = nb.bank_scan(*args, **form)
        assert counter.launches == launches + 1, form
        same = (got_c == ref_c).all(0)
        assert same.sum() >= B - max(1, B // 10), (form, same)
        assert not (got_c == 3).any() and not got_c[t(is_end) == 0].any()
        torch.testing.assert_close(got_p[:, same], ref_p[:, same], rtol=0, atol=1e-4)
        again = nb.bank_scan(*args, **form)
        assert torch.equal(got_c, again[0]) and torch.equal(got_p, again[1]), form


def test_nipt_bank_refuses_what_it_has_no_instantiation_for(cuda):
    """A form without an instantiation raises: the general form where the
    bank exceeds a block's shared memory, register columns too few for K or
    not instantiated, the global form without scratch; nothing falls back."""
    G, B, K = 4, 2, 7000
    z = lambda *shape, dt=torch.float32: torch.zeros(shape, dtype=dt, device=cuda)
    args = (z(G, 3 * B, K), z(G, 3 * B, K), z(2, G), z(G, B, 6), z(G, B),
            z(G, B, dt=torch.int32), torch.ones(6, device=cuda), K)
    out = z(G * B * 7)
    for K_, cpt in ((7000, gs.GENERAL),       # 9 x 7,000 floats: above a block's
                    (640, 3), (640, 4),       # no such form; 8 x 128 < 7,000
                    (7000, 8), (7000, 0), (7000, -4),
                    (16512, gs.CLUSTER)):     # past 16 blocks x 1,024
        with pytest.raises(RuntimeError, match="cudaError"):
            nb.BANK_KERNEL.launch(*(a.data_ptr() for a in args[:7]), out.data_ptr(),
                                  out.data_ptr(), G, B, K_, 600, cpt, 1 / 600, out.data_ptr())
    with pytest.raises(RuntimeError, match="cudaError"):
        nb.BANK_KERNEL.launch(*(a.data_ptr() for a in args[:7]), out.data_ptr(),
                              out.data_ptr(), G, B, K, 600, gs.GLOBAL, 1 / 600, None)


def test_nipt_bank_floor_runs(cuda):
    out = nb.bank_floor(100, 3, cuda)
    torch.cuda.synchronize()
    assert out.shape == (3,) and torch.isfinite(out).all()
    out = nb.bank_cluster_floor(100, 3, cuda)
    torch.cuda.synchronize()
    assert out.shape == (48,) and torch.isfinite(out).all()


@pytest.mark.parametrize("values", [8, 12])
def test_sweep_cluster_floor_runs(cuda, values):
    out = gs.cluster_floor(100, 3, cuda, values=values)
    torch.cuda.synchronize()
    assert out.shape == (24,) and torch.isfinite(out).all()
    # every block of a cluster holds the same sums
    assert torch.equal(out.view(3, 8), out.view(3, 8)[:, :1].expand(3, 8))


@pytest.mark.parametrize("nl,K,K_real,G,B,W", [
    (2, 10368, 10300, 4, 2, 3),    # the wide path's Ksubset: past the general variant
    (3, 10368, 10300, 4, 2, 3),
    (3, 8192, 8150, 4, 2, 3),      # the wide NIPT path's: one ring stage no longer fits
    (2, 12288, 12220, 4, 2, 3),
    (3, 12288, 12288, 3, 1, 2),    # the cluster form's last K at NL = 3
    (2, 16384, 16300, 3, 1, 2),    # and at NL = 2
    (2, 10241, 10241, 3, 2, 3),    # K no multiple of 4: 1,284 columns a block, the last 1,253
])
def test_sweep_cluster_forms_match_plain(cuda, nl, K, K_real, G, B, W):
    """The forward sweep's cluster form (one chain on a cluster of 8 blocks,
    each a register form over its slice of the columns; the blocks exchange
    each step's sums) from the shared-memory forms' limit to its capacity,
    against the plain version at the tolerances above, under its own launch
    count (the global and register forms' counts unchanged); two launches
    equal bit for bit."""
    assert gs.fwd_form(K, nl) == gs.CLUSTER
    prior = (0.5, 0.5) if nl == 2 else (0.5, 0.4, 0.1)
    state = random_sweep_state(np.random.default_rng(K + nl + 7), G, B, W, K, K_real, W, nl=nl)
    args = [torch.from_numpy(x).to(cuda) for x in state]
    live = args[3][:, 2] == 0
    counts = (gs.FWD_CLUSTER_KERNELS[nl], gs.FWD_GLOBAL_KERNELS[nl], gs.FWD_KERNELS[nl])
    before = [k.launches for k in counts]
    form = dict(_variant=gs.CLUSTER)
    for it_mode in (0, 2):
        ref = gs.fwd_sweep_plain(*args, K_real=K_real, it_mode=it_mode, nl=nl, prior=prior)
        got = gs.fwd_sweep(*args, nl=nl, K_real=K_real, it_mode=it_mode, prior=prior, **form)
        assert (got[2][live] == ref[2][live]).float().mean().item() > 0.995
        assert torch.equal(got[2][~live], ref[2][~live])
        same = ((got[2] == ref[2]) | ~live).all(0).all(0)
        rows = torch.cat([same] * nl)
        assert 1.0 - same.float().mean().item() <= 0.1
        torch.testing.assert_close(got[0][:, rows], ref[0][:, rows], rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(got[1][:, rows], ref[1][:, rows], rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(got[3][rows], ref[3][rows], rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(got[5][same], ref[5][same], rtol=0, atol=0)
        assert torch.equal(got[4], ref[4])
        again = gs.fwd_sweep(*args, nl=nl, K_real=K_real, it_mode=it_mode, prior=prior, **form)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert [k.launches for k in counts] == [before[0] + 4, before[1], before[2]]


@pytest.mark.parametrize("rows", [16, 112])
@pytest.mark.parametrize("K,K_real", [
    (10368, 10300),    # the wide path's Ksubset: past the general variant
    (12288, 12220),    # the wide NIPT path's at the forms' capacity
    (16384, 16300),    # the cluster form's last K
    (10241, 10241),    # K no multiple of 4: 1,284 columns a block, the last 1,253
])
def test_sweep_backward_cluster_form_matches_plain(cuda, K, K_real, rows):
    """The backward sweep's cluster form (a state row on a thread-block
    cluster, each block a register form over its slice of the columns; the
    step's sums and the next grid's row maximum exchanged) against the plain
    version at rtol 1e-5 / atol 1e-6, at the wide path's 16 state rows and
    a full batch's 112, under its own launch count (the global and register
    forms' counts unchanged); two launches equal bit for bit; past its
    capacity the form is refused."""
    rng = np.random.default_rng(K + rows)
    G = 6
    lemg = torch.from_numpy(rng.uniform(-20.0, 0.0, (G, rows, K)).astype(np.float32)).to(cuda)
    trans = np.stack([np.full(G, 0.98), np.full(G, 0.02)]).astype(np.float32)
    trans[:, 0] = (1.0, 0.0)
    trans = torch.from_numpy(trans).to(cuda)
    counts = (gs.BWD_CLUSTER_KERNEL, gs.BWD_GLOBAL_KERNEL, gs.BWD_KERNELS[2])
    before = [k.launches for k in counts]
    ref = gs.bwd_sweep_plain(lemg, trans, K_real)
    got = gs.bwd_sweep(lemg, trans, nl=2, K_real=K_real, _variant=gs.CLUSTER)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    again = gs.bwd_sweep(lemg, trans, nl=2, K_real=K_real, _variant=gs.CLUSTER)
    assert torch.equal(got, again)
    assert [k.launches for k in counts] == [before[0] + 2, before[1], before[2]]
    with pytest.raises(RuntimeError, match="gibbs_bwd"):
        gs.bwd_sweep(torch.zeros((2, 2, 16512), device=cuda), trans[:, :2].contiguous(), nl=2,
                     K_real=16500, _variant=gs.CLUSTER)


@pytest.mark.parametrize("G,B,K,K_real,p_end", [
    (512, 4, 6272, 6200, 0.05),       # the general form's bank outgrows shared memory at 512 grids
    (32, 14, 8192, 8100, 0.1),        # the wide NIPT path's shape
    (512, 2, 12288, 12200, 0.05),
    (64, 3, 16384, 16384, 0.1),       # the cluster form's last K
])
def test_nipt_bank_cluster_form_matches_plain(cuda, G, B, K, K_real, p_end):
    """The bank's cluster form (one chain on a cluster of 16 blocks, each a
    register form over its slice) against the plain version, under its own
    launch count; two launches equal bit for bit."""
    assert nb.bank_form(K, G) == gs.CLUSTER
    rng = np.random.default_rng(G + K)
    lemg, beta = (torch.from_numpy(x).to(cuda) for x in random_sweep_state(
        rng, G, B, 2, K, K_real, 2, nl=3)[:2])
    trans = np.stack([rng.uniform(0.9, 0.999, G), rng.uniform(0.001, 0.1, G)]).astype(np.float32)
    trans[:, 0] = (1.0, 0.0)
    is_end = (rng.random((G, B)) < p_end).astype(np.int32)
    is_end[G - 1] = 1
    t = lambda x: torch.from_numpy(x).to(cuda)
    args = (lemg, beta, t(trans), t(rng.normal(0, 2, (G, B, 6)).astype(np.float32)),
            t(rng.random((G, B)).astype(np.float32)), t(is_end), torch.ones(6, device=cuda),
            K_real)
    ref_c, ref_p = nb.bank_scan_plain(*args)
    counts = (nb.BANK_CLUSTER_KERNEL, nb.BANK_GLOBAL_KERNEL, nb.BANK_KERNEL)
    before = [k.launches for k in counts]
    got_c, got_p = nb.bank_scan(*args)
    assert [k.launches for k in counts] == [before[0] + 1, before[1], before[2]]
    same = (got_c == ref_c).all(0)
    assert same.sum() >= B - max(1, B // 10) and same.any()
    torch.testing.assert_close(got_p[:, same], ref_p[:, same], rtol=0, atol=1e-4)
    again = nb.bank_scan(*args)
    assert torch.equal(got_c, again[0]) and torch.equal(got_p, again[1])


@pytest.mark.parametrize("quilt2", [False, True])
def test_nipt_engine_on_gpu(cuda, quilt2):
    """NIPT at a small size: QUILT1-NIPT launches the sweeps at NL = 3 and
    the fused FB, QUILT2-NIPT the dosage kernel at NL = 3 as well; no NL = 2
    sweep runs. Bounds: maternal r2 0.85, fetal r2 0.5."""
    from quilt_tpu_torch.engine.driver import ImputeConfig, quilt_impute
    from quilt_tpu_torch.out.metrics import r2_simple

    ffs = [0.2, 0.2, 0.3]
    world = make_world(np.random.default_rng(7), K=120, nSNPs=640, n_samples=3, coverage=4.0,
                       rare_frac=0.1 if quilt2 else 0.0, quilt2=quilt2, ffs=ffs)
    nl3 = [gs.FWD_KERNELS[3], gs.BWD_KERNELS[3], nb.BANK_KERNEL] + ([gd.DOS_KERNELS[3]] if quilt2 else
                                                  [fbk.FWD_KERNEL, fbk.BWD_KERNEL])
    for k in nl3 + [gs.FWD_KERNEL, gs.BWD_KERNEL]:
        k.launches = 0
    out = quilt_impute(world["prep"], world["samples"], ["a", "b", "c"],
                       ImputeConfig(method="nipt", nGibbsSamples=3, n_seek_its=2, Ksubset=48,
                                    Knew=48, small_ref_panel_gibbs_iterations=8, seed=3,
                                    use_mspbwt=quilt2, impute_rare_common=quilt2),
                       "cuda", ff_values=np.array(ffs))
    for t, res in zip(world["truths"], out.results):
        assert r2_simple((t[0] + t[1]).astype(float), res.mat_dosage) > 0.85
        assert r2_simple((t[0] + t[2]).astype(float), res.fet_dosage) > 0.5
    assert all(k.launches > 0 for k in nl3), [k.launches for k in nl3]
    assert gs.FWD_KERNEL.launches == 0 and gs.BWD_KERNEL.launches == 0


@pytest.mark.parametrize("nl,K,K_real,G,B,W", [
    (2, 16512, 16450, 4, 2, 3),          # past the cluster form's 16,384 columns
    (3, 12416, 12350, 4, 2, 3),          # NL = 3: past its 12,288
    (3, 16512, 16512, 3, 1, 2),
    (2, 40960, 40900, 2, 1, 2),
])
def test_sweep_global_forms_match_plain(cuda, nl, K, K_real, G, B, W):
    """The global forms of the two sweep kernels (no ring, the state in a
    scratch plane) at K just past the other forms' limits (the forward's
    cluster form's capacity), against the plain versions, under their own
    launch counts; two launches equal bit for bit."""
    assert gs.fwd_form(K, nl) == gs.GLOBAL
    prior = (0.5, 0.5) if nl == 2 else (0.5, 0.4, 0.1)
    state = random_sweep_state(np.random.default_rng(K + nl), G, B, W, K, K_real, W, nl=nl)
    args = [torch.from_numpy(x).to(cuda) for x in state]
    live = args[3][:, 2] == 0
    launches = (gs.FWD_GLOBAL_KERNELS[nl].launches, gs.FWD_KERNELS[nl].launches)
    for it_mode in (0, 2):
        ref = gs.fwd_sweep_plain(*args, K_real=K_real, it_mode=it_mode, nl=nl, prior=prior)
        got = gs.fwd_sweep(*args, nl=nl, K_real=K_real, it_mode=it_mode, prior=prior)
        assert (got[2][live] == ref[2][live]).float().mean().item() > 0.995
        assert torch.equal(got[2][~live], ref[2][~live])
        same = ((got[2] == ref[2]) | ~live).all(0).all(0)
        rows = torch.cat([same] * nl)
        assert same.any()
        torch.testing.assert_close(got[0][:, rows], ref[0][:, rows], rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(got[1][:, rows], ref[1][:, rows], rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(got[3][rows], ref[3][rows], rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(got[5][same], ref[5][same], rtol=0, atol=0)
        assert torch.equal(got[4], ref[4])
        again = gs.fwd_sweep(*args, nl=nl, K_real=K_real, it_mode=it_mode, prior=prior)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert gs.FWD_GLOBAL_KERNELS[nl].launches == launches[0] + 4
    assert gs.FWD_KERNELS[nl].launches == launches[1]
    if gs.bwd_form(K) == gs.GLOBAL:
        launches = gs.BWD_GLOBAL_KERNEL.launches
        beta = gs.bwd_sweep(args[0], args[6], nl=nl, K_real=K_real)
        assert gs.BWD_GLOBAL_KERNEL.launches == launches + 1
        torch.testing.assert_close(beta, gs.bwd_sweep_plain(args[0], args[6], K_real),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("G,B,K,K_real,p_end", [
    (512, 2, 16512, 16440, 0.05),        # past the cluster form's 16,384 columns
    (19300, 1, 40, 36, 0.001),           # the staged scalars of 19,300 grids outgrow shared memory
])
def test_nipt_bank_global_form_matches_plain(cuda, G, B, K, K_real, p_end):
    """The bank's global form (the bank and the staged scalars in a scratch
    plane) against the plain version, under its own launch count; two
    launches equal bit for bit."""
    assert nb.bank_form(K, G) == gs.GLOBAL
    rng = np.random.default_rng(G + K)
    lemg, beta = (torch.from_numpy(x).to(cuda) for x in random_sweep_state(
        rng, G, B, 2, K, K_real, 2, nl=3)[:2])
    trans = np.stack([rng.uniform(0.9, 0.999, G), rng.uniform(0.001, 0.1, G)]).astype(np.float32)
    trans[:, 0] = (1.0, 0.0)
    is_end = (rng.random((G, B)) < p_end).astype(np.int32)
    is_end[G - 1] = 1
    t = lambda x: torch.from_numpy(x).to(cuda)
    args = (lemg, beta, t(trans), t(rng.normal(0, 2, (G, B, 6)).astype(np.float32)),
            t(rng.random((G, B)).astype(np.float32)), t(is_end), torch.ones(6, device=cuda),
            K_real)
    ref_c, ref_p = nb.bank_scan_plain(*args)
    launches = nb.BANK_GLOBAL_KERNEL.launches, nb.BANK_KERNEL.launches
    got_c, got_p = nb.bank_scan(*args)
    assert (nb.BANK_GLOBAL_KERNEL.launches, nb.BANK_KERNEL.launches) == (launches[0] + 1,
                                                                         launches[1])
    same = (got_c == ref_c).all(0)
    assert same.sum() >= B - max(1, B // 10) and same.any()
    torch.testing.assert_close(got_p[:, same], ref_p[:, same], rtol=0, atol=1e-4)
    again = nb.bank_scan(*args)
    assert torch.equal(got_c, again[0]) and torch.equal(got_p, again[1])


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("B", [1, 28, 200])
def test_fb_max_tiled_matches_plain(cuda, splits, B):
    """The emission maxima at a ragged K (2,000 of K_pad 2,048) against the
    plain version within max_tiled_tolerance (byte tables add a logit's
    log-ratios in another order than the nibble order); whatever the split,
    the same maxima; the previous form (timings only) equal to the plain
    version."""
    K, nG = 2000, 16
    fb = _random_fb(K, nG, B + splits)
    words = fb.device_tensors(cuda)["words"]
    gen = torch.Generator(device=cuda).manual_seed(B)
    gl = 0.05 + 0.95 * torch.rand((B, 2, fb.S), generator=gen, device=cuda)
    dl, _ = fbk._gl_log_ratios(gl, 0.001)
    kt = fb.K_pad // splits
    launches = fbk.MAX_TILED_KERNEL.launches
    mx = fbk.fb_max_tiled(dl, words, K, kt)
    assert fbk.MAX_TILED_KERNEL.launches == launches + 1
    ref = fbk.fb_max_tiled_plain(dl, words, K, kt)
    tol = fbk.max_tiled_tolerance(dl, nG)
    assert ((mx - ref).abs() <= tol).all(), (mx - ref).abs().max().item()
    assert torch.equal(mx, fbk.fb_max_tiled(dl, words, K, fb.K_pad))
    assert torch.equal(fbk.fb_max_tiled(dl, words, K, kt, _prev=True), ref)


def test_engine_on_gpu_at_a_large_ksubset(cuda):
    """Diploid imputation at Ksubset 10,368, where the forward sweep takes
    its cluster form and the backward the form bwd_form names there (and
    the dosage-free QUILT1 path runs no other Gibbs form): r2 above 0.9,
    those two forms launched and no other."""
    from quilt_tpu_torch.engine.driver import ImputeConfig, quilt_impute

    world = make_world(np.random.default_rng(11), K=10496, nSNPs=640, n_samples=2,
                       coverage=1.5)
    bwd = {gs.CLUSTER: (gs.BWD_CLUSTER_KERNEL, gs.BWD_GLOBAL_KERNEL),
           gs.GLOBAL: (gs.BWD_GLOBAL_KERNEL, gs.BWD_CLUSTER_KERNEL)}[gs.bwd_form(10368)]
    kernels = [gs.FWD_CLUSTER_KERNELS[2], bwd[0], gs.FWD_KERNEL, gs.BWD_KERNEL,
               gs.FWD_GLOBAL_KERNELS[2], bwd[1]]
    for k in kernels:
        k.launches = 0
    truth_gen = np.stack([t.sum(0) for t in world["truths"]], 1).astype(float)
    out = quilt_impute(world["prep"], world["samples"], ["a", "b"],
                       ImputeConfig(nGibbsSamples=2, n_seek_its=1, Ksubset=10368, Knew=10368,
                                    small_ref_panel_gibbs_iterations=4, seed=3),
                       "cuda", truth_gen=truth_gen)
    assert min(out.r2_per_sample) > 0.9, out.r2_per_sample
    launches = [k.launches for k in kernels]
    assert launches[0] > 0 and launches[1] > 0 and launches[2:] == [0, 0, 0, 0], launches


def test_engine_on_gpu_at_map(cuda):
    """Block Gibbs at the static map boundaries on the card, diploid and
    NIPT, on a world with a hot genetic map: r2 above 0.9 (NIPT maternal
    0.85), the Gibbs sweeps, the FB and (NIPT) the bank launched."""
    from quilt_tpu_torch.engine.driver import ImputeConfig, quilt_impute

    opts = dict(nGibbsSamples=3, n_seek_its=2, Ksubset=48, Knew=48,
                small_ref_panel_gibbs_iterations=8, seed=3,
                block_gibbs_boundary_detection="map")
    world = make_world(np.random.default_rng(5), K=120, nSNPs=1024, n_samples=3,
                       coverage=1.5, hot_map=True)
    kernels = [gs.FWD_KERNEL, gs.BWD_KERNEL, fbk.FWD_KERNEL, fbk.BWD_KERNEL]
    for k in kernels:
        k.launches = 0
    truth_gen = np.stack([t.sum(0) for t in world["truths"]], 1).astype(float)
    out = quilt_impute(world["prep"], world["samples"], ["a", "b", "c"],
                       ImputeConfig(**opts), "cuda", truth_gen=truth_gen)
    assert min(out.r2_per_sample) > 0.9, out.r2_per_sample
    assert all(k.launches > 0 for k in kernels), [k.launches for k in kernels]
    nipt = make_world(np.random.default_rng(6), K=120, nSNPs=1024, n_samples=2,
                      coverage=2.0, hot_map=True, ffs=[0.2, 0.2])
    nl3 = [gs.FWD_KERNELS[3], gs.BWD_KERNELS[3], nb.BANK_KERNEL]
    for k in nl3:
        k.launches = 0
    out = quilt_impute(nipt["prep"], nipt["samples"], ["a", "b"],
                       ImputeConfig(**opts, method="nipt"), "cuda", ff_values=[0.2, 0.2],
                       truth_gen=np.stack([t[:2].sum(0) for t in nipt["truths"]], 1).astype(float))
    assert min(out.r2_per_sample) > 0.85, out.r2_per_sample
    assert all(k.launches > 0 for k in nl3), [k.launches for k in nl3]


def test_diagnostics_on_gpu(cuda, tmp_path):
    """The nine diagnostic options on the card through the per-sample
    engine: the npz objects, the plots' data files and the OHD field."""
    from quilt_tpu_torch.engine.driver import ImputeConfig, quilt_impute
    from quilt_tpu_torch.out.bgzf import bgzf_open

    world = make_world(np.random.default_rng(7), K=120, nSNPs=640, n_samples=2,
                       coverage=1.5)
    truth_gen = np.stack([t.sum(0) for t in world["truths"]], 1).astype(float)
    truth_haps = np.stack([t.T for t in world["truths"]], 1).astype(float)
    cfg = ImputeConfig(nGibbsSamples=3, n_seek_its=2, Ksubset=48, Knew=48,
                       small_ref_panel_gibbs_iterations=8, seed=3, outputdir=str(tmp_path),
                       make_heuristic_plot=True, record_read_label_usage=True,
                       record_interim_dosages=True, output_read_label_prob=True,
                       RData_objects_to_save=["dosage", "seek_dosages", "read_label_usage",
                                              "per_it_likelihoods"],
                       output_RData_filename=str(tmp_path / "objects.npz"), make_plots=True,
                       plot_per_sample_likelihoods=True, addOptimalHapsToVCF=True)
    vcf = str(tmp_path / "out.vcf.gz")
    quilt_impute(world["prep"], world["samples"], ["a", "b"], cfg, "cuda",
                 output_filename=vcf, truth_gen=truth_gen, truth_haps=truth_haps,
                 region_name="chr20")
    with np.load(tmp_path / "objects.npz") as z:
        assert {f"{o}_{s}" for o in ("dosage", "seek_dosages", "read_label_usage",
                                    "per_it_likelihoods") for s in "ab"} == set(z.files)
    for s in "ab":
        assert (tmp_path / "plots" / f"haps.{s}.chr20.diagnostics.tsv.gz").exists()
        assert (tmp_path / "plots" / f"heuristic.{s}.chr20.tsv").exists()
    lines = list(bgzf_open(vcf))
    assert any(l.startswith("##FORMAT=<ID=OHD") for l in lines)
    body = [l for l in lines if not l.startswith("#")]
    for i in range(2):
        ohd = np.array([[float(x) for x in l.split("\t")[9 + i].split(":")[4].split(",")]
                        for l in body])
        assert np.isfinite(ohd).all()
        assert np.corrcoef(ohd.sum(1), truth_gen[:, i])[0, 1] ** 2 > 0.9


def _seg_inputs(cuda, KS, K_loc, B, Gp=32, tied=False):
    """One shard's segment-kernel inputs: random words (columns 2m and
    2m + 1 equal when tied), random GL log-ratios, 3% jumps, every fifth
    grid thinned, the emission maxima."""
    rng = np.random.default_rng(KS + B)
    T = lambda x: torch.as_tensor(x, device=cuda)
    words = rng.integers(-2**31, 2**31, (Gp, KS), dtype=np.int64).astype(np.int32)
    if tied:
        words[:, 1::2] = words[:, 0::2][:, :KS // 2]
    gl = 0.05 + 0.95 * rng.random((B, 2, Gp * 32))
    dl = T(np.log((gl[:, 0] * 0.001 + gl[:, 1] * 0.999) / (gl[:, 0] * 0.999 + gl[:, 1] * 0.001))
           .astype(np.float32))
    trans2 = T(np.stack([np.full(Gp, 0.97), np.full(Gp, 0.03)]).astype(np.float32))
    trans2[:, 0] = 1.0
    thin = T(np.where(np.arange(Gp) % 5 == 2, 0, -1).astype(np.int32))
    words = T(words)
    mx = (fbk.fb_max_tiled(dl, words, K_loc, KS) if K_loc else
          torch.zeros((Gp, B), dtype=torch.float32, device=cuda))
    return dl, words, trans2, thin, mx


def _seg_close(got, ref, per_col=False):
    """chip_smoke.py's tolerance: rtol 1e-4 plus 1e-6 of the largest value
    (of each value column with per_col)."""
    dims = tuple(range(ref.dim() - 1))
    scale = ref.abs().amax(dim=dims, keepdim=True) if per_col and dims else ref.abs().max()
    assert torch.isfinite(got).all()
    assert ((got - ref).abs() <= 1e-4 * ref.abs() + 1e-6 * scale).all()


def _seg_outs(cuda, nt, B, Gp, KS, K_top):
    return {"dpart": torch.zeros((nt, B, Gp * 32), device=cuda),
            "gnp": torch.zeros((nt, Gp, B), device=cuda),
            "tvp": torch.zeros((nt, Gp, B, K_top), device=cuda),
            "tip": torch.zeros((nt, Gp, B, K_top), dtype=torch.int32, device=cuda),
            "gcap": torch.zeros((B, KS), device=cuda)}


@pytest.mark.parametrize("KS,K_loc,B", [(700, 640, 3), (1280, 1280, 14), (128, 0, 2)])
def test_fb_sharded_kernels_match_plain(cuda, KS, K_loc, B):
    """The previous form's four segment kernels (csrc/fb_sharded.cu: the
    local passes, which the path still launches once a call, and the apply
    passes, kept for timing) against their plain versions on one shard,
    every segment of 32 grids, each pass given the same inputs (the
    kernels' state carried on); a ragged tile, padded haplotypes, an empty
    shard; capture in the backward; two launches equal bit for bit.
    Tolerance as chip_smoke.py's: rtol 1e-4 plus 1e-6 of the largest value
    (of each sum, for the local passes' sums)."""
    from quilt_tpu_torch.kernels import fb_sharded as fs

    Gp, K, K_top = 32, max(K_loc, 1) + 40, 4
    L, nt = fs.SEG_LEN, fs.n_tiles(KS)
    dl, words, trans2, thin, mx = _seg_inputs(cuda, KS, K_loc, B, Gp)
    args = (dl, words, trans2, mx)
    alphas = torch.zeros((Gp, B, KS), dtype=torch.float32, device=cuda)
    logm = torch.zeros((Gp // L, B), dtype=torch.float32, device=cuda)
    for c in range(Gp // L):
        a0 = alphas[c * L - 1] if c else None
        part = fs.seg_fwd_local(*args, a0, c, K_loc)
        _seg_close(part, fs.seg_fwd_local_plain(*args, a0, c, K_loc), per_col=True)
        assert torch.equal(part, fs.seg_fwd_local(*args, a0, c, K_loc))
        tot = part.sum(1) + 1e-3          # the other shards' share of the sums
        a, lm = torch.zeros((L, B, KS), device=cuda), logm.clone()
        fs.seg_fwd_apply_plain(*args, tot, a0, a, lm, c, K_loc, K)
        fs.seg_fwd_apply(*args, tot, a0, alphas[c * L:(c + 1) * L], logm, c, K_loc, K)
        _seg_close(alphas[c * L:(c + 1) * L], a)
        _seg_close(logm, lm)
    out, ref = (_seg_outs(cuda, nt, B, Gp, KS, K_top) for _ in range(2))
    beta = torch.ones((B, KS), dtype=torch.float32, device=cuda)
    for c in range(Gp // L - 1, -1, -1):
        part = fs.seg_bwd_local(*args, beta, c, K_loc)
        _seg_close(part, fs.seg_bwd_local_plain(*args, beta, c, K_loc), per_col=True)
        assert torch.equal(part, fs.seg_bwd_local(*args, beta, c, K_loc))
        tot = part.sum(1) + 1e-3
        b = beta.clone()
        seg_a = alphas[c * L:(c + 1) * L]
        fs.seg_bwd_apply_plain(*args, seg_a, tot, thin, b, ref, c, K_loc, K, 100, 13)
        fs.seg_bwd_apply(*args, seg_a, tot, thin, beta, out, c, K_loc, K, 100, 13)
        _seg_close(beta, b)
    for k in ("dpart", "gnp", "tvp", "gcap"):
        _seg_close(out[k], ref[k])
    firm = (ref["tvp"][..., :-1] - ref["tvp"][..., 1:]) > 1e-6 * ref["tvp"].abs().max()
    assert torch.equal(out["tip"][..., :-1][firm], ref["tip"][..., :-1][firm])


@pytest.mark.parametrize("KS,K_loc,B,tied", [(2560, 2560, 56, False), (2560, 2560, 112, False),
                                             (700, 640, 3, True), (1000, 1000, 14, True),
                                             (128, 0, 2, False)])
def test_fb_sharded_step_kernels_match_plain(cuda, KS, K_loc, B, tied):
    """seg_fwd_step and seg_bwd_step (with seg_fwd_local of the first
    segment and seg_bwd_local of the last) against their plain versions on
    one shard of 4 segments, each launch given the same inputs as its plain
    version (the kernels' state carried on): at the dist path's 56 rows x
    2,560 and the timing shape's 112, at K_shard 700 and 1,000 (no
    multiple of 512; columns 2m and 2m + 1 equal, so the gammas tie at the
    thinned grids) and an empty shard; the capture grid's segment; two
    launches equal bit for bit; the backward's rebuilt alphas equal the
    forward's bit for bit. Tolerance: rtol 1e-4 plus 1e-6 of the largest;
    top-K haplotypes equal where firm."""
    from quilt_tpu_torch.kernels import fb_sharded as fs

    Gp, K, K_top, cap = 32, max(K_loc, 1) + 40, 8, 13
    L, nt, NSC = fs.SEG_LEN, fs.n_tiles(KS), Gp // fs.SEG_LEN
    dl, words, trans2, thin, mx = _seg_inputs(cuda, KS, K_loc, B, Gp, tied)
    args = (dl, words, trans2, mx)
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=cuda)
    ckpt, scal, logm = z(NSC, B, KS), z(NSC, B, fs.SCAL_VALS), z(NSC, B)
    part = fs.seg_fwd_local(*args, None, 0, K_loc)
    _seg_close(part, fs.seg_fwd_local_plain(*args, None, 0, K_loc), per_col=True)
    fwd_alphas = []
    for c in range(NSC):
        tot = part.sum(1) + 1e-3          # the other shards' share of the sums
        state = [(ckpt.clone(), scal.clone(), logm.clone(), z(L, B, KS)) for _ in range(2)]
        a = z(L, B, KS)
        part = fs.seg_fwd_step(*args, tot, ckpt, scal, logm, c, K_loc, K, _alphas=a)
        (ck1, sc1, lm1, a1), (ck2, sc2, lm2, a2) = state
        ref = fs.seg_fwd_step_plain(*args, tot, ck1, sc1, lm1, c, K_loc, K, a1)
        again = fs.seg_fwd_step(*args, tot, ck2, sc2, lm2, c, K_loc, K, _alphas=a2)
        for got, r, g2 in ((ckpt, ck1, ck2), (scal, sc1, sc2), (logm, lm1, lm2), (a, a1, a2)):
            _seg_close(got, r)
            assert torch.equal(got, g2)
        if c + 1 < NSC:
            _seg_close(part, ref, per_col=True)
            assert torch.equal(part, again)
        else:
            assert part is None and ref is None and again is None
        fwd_alphas.append(a)
    out, ref_out = (_seg_outs(cuda, nt, B, Gp, KS, K_top) for _ in range(2))
    beta = torch.ones((B, KS), dtype=torch.float32, device=cuda)
    part = fs.seg_bwd_local(*args, beta, NSC - 1, K_loc)
    _seg_close(part, fs.seg_bwd_local_plain(*args, beta, NSC - 1, K_loc), per_col=True)
    for c in range(NSC - 1, -1, -1):
        tot = part.sum(1) + 1e-3
        b1, b2 = beta.clone(), beta.clone()
        o2 = {k: v.clone() for k, v in out.items()}
        a, a1, a2 = z(L, B, KS), z(L, B, KS), z(L, B, KS)
        part = fs.seg_bwd_step(*args, ckpt, scal, tot, thin, beta, out, c, K_loc, K, 100, cap,
                               _alphas=a)
        ref = fs.seg_bwd_step_plain(*args, ckpt, scal, tot, thin, b1, ref_out, c, K_loc, K, 100,
                                    cap, a1)
        again = fs.seg_bwd_step(*args, ckpt, scal, tot, thin, b2, o2, c, K_loc, K, 100, cap,
                                _alphas=a2)
        assert torch.equal(a, fwd_alphas[c]) and torch.equal(a2, a)
        _seg_close(a1, a)
        _seg_close(beta, b1)
        assert torch.equal(beta, b2)
        assert all(torch.equal(out[k], o2[k]) for k in out)
        if c:
            _seg_close(part, ref, per_col=True)
            assert torch.equal(part, again)
        else:
            assert part is None and ref is None and again is None
    for k in ("dpart", "gnp", "tvp", "gcap"):
        _seg_close(out[k], ref_out[k])
    if K_loc:
        assert out["gcap"].abs().sum() > 0
    firm = (ref_out["tvp"][..., :-1] - ref_out["tvp"][..., 1:]) > 1e-6 * ref_out["tvp"].abs().max()
    assert torch.equal(out["tip"][..., :-1][firm], ref_out["tip"][..., :-1][firm])
    if tied:
        # equal columns: equal gammas, the lower index first
        tv, ti = out["tvp"][:, thin >= 0], out["tip"][:, thin >= 0]
        assert torch.equal(tv[..., 0::2], tv[..., 1::2])
        assert torch.equal(ti[..., 1::2], ti[..., 0::2] + 1)


@pytest.mark.parametrize("n_panel,B", [(2, 56), (2, 112), (3, 14), (4, 5)])
def test_fb_sharded_step_body_matches_the_previous_form(cuda, n_panel, B):
    """sharded_core's step body against its previous four-pass body
    (_prev=True) on one data row of n_panel shards on the one card, with
    capture: dosage, top-K values and the captured gamma atol 1e-5,
    log-likelihood rtol 1e-5, top-K haplotypes equal where firm; two calls
    equal bit for bit."""
    from quilt_tpu_torch.dist.mesh import ShardedFB
    from quilt_tpu_torch.dist import make_mesh
    from quilt_tpu_torch.kernels import fb_sharded as fs

    rng = np.random.default_rng(n_panel + B)
    fb = _random_fb(5120 if B >= 56 else 1000, 64, n_panel, capture_grid=20)
    gl = torch.as_tensor((0.05 + 0.95 * rng.random((B, 2, fb.S))).astype(np.float32), device=cuda)
    sfb = ShardedFB(fb, make_mesh(1, n_panel, [cuda] * n_panel), K_top=8)
    (group, shards), = sfb.rows
    run = lambda prev: fs.sharded_core(gl, shards, group, fb.K, 8, 0.001, fb.capture_grid,
                                       _prev=prev)
    new, old, again = run(False), run(True), run(False)
    assert all(torch.equal(a, b) for a, b in zip(new, again))
    d, ll, tv, ti, g = new
    d_r, l_r, tv_r, ti_r, g_r = old
    assert torch.allclose(d, d_r, atol=1e-5)
    assert torch.allclose(ll, l_r, rtol=1e-5)
    thin = torch.as_tensor(fb.thin_flag >= 0, device=cuda)
    assert torch.allclose(tv[thin], tv_r[thin], atol=1e-5)
    firm = (tv_r[thin][..., :-1] - tv_r[thin][..., 1:]) > 1e-3
    assert torch.equal(ti[thin][..., :-1][firm], ti_r[thin][..., :-1][firm])
    assert torch.allclose(g, g_r, atol=1e-5)


@pytest.mark.parametrize("n_panel,B", [(2, 14), (4, 5)])
def test_fb_full_sharded_on_gpu_matches_the_fused_fb(cuda, n_panel, B):
    """fb_full_sharded over make_mesh(1 or 2, n) on the one card against
    fb_full_batched (fused), with capture: dosage and top-K values atol
    1e-5, log-likelihood rtol 1e-5, top-K haplotypes equal where firm."""
    from quilt_tpu_torch.dist import fb_full_sharded, make_mesh

    rng = np.random.default_rng(n_panel)
    fb = _random_fb(1000, 64, n_panel, capture_grid=20)
    gl = torch.as_tensor((0.05 + 0.95 * rng.random((B, 2, fb.S))).astype(np.float32), device=cuda)
    d_r, l_r, tv_r, ti_r, g_r = fbk.fb_full_batched(gl, fb, K_top=8, family="fused")
    n_data = 2 if n_panel == 2 else 1
    d, ll, tv, ti, g = fb_full_sharded(gl, fb, make_mesh(n_data, n_panel, [cuda] * 4), K_top=8)
    assert torch.allclose(d, d_r[:, :fb.nSNPs], atol=1e-5)
    assert torch.allclose(ll, l_r, rtol=1e-5)
    thin = torch.as_tensor(fb.thin_flag >= 0, device=cuda)
    assert torch.allclose(tv[thin][..., :8], tv_r[thin], atol=1e-5)
    firm = (tv_r[thin][..., :-1] - tv_r[thin][..., 1:]) > 1e-3
    assert torch.equal(ti[thin][..., :7][firm], ti_r[thin][..., :7][firm])
    assert torch.allclose(g, g_r, atol=1e-5)


@pytest.mark.parametrize("splits", [2, 4, 8])
def test_fb_tiled_kernels_at_98304_match_plain(cuda, splits):
    """The K-split kernels at the benchmark's 98,304-haplotype panel x 16
    grids (8 grids and their padding to GRID_CHUNK) at each split fb_plan
    takes there (2 at 112 rows: 49,152 haplotypes a block, alpha planes in
    global memory; 8 at 16 rows: 12,288; and 4), held against their plain
    versions at chip_smoke.py's tolerances; two launches of each give the
    same bits."""
    fb = _random_fb(98304, 16, 98304 + splits)
    dev = fb.device_tensors(cuda)
    words, trans2, thin = dev["words"], dev["trans2"], dev["thin_flag"]
    gen = torch.Generator(device=cuda).manual_seed(splits)
    gl = 0.05 + 0.95 * torch.rand((3, 2, fb.S), generator=gen, device=cuda)
    dl, _ = fbk._gl_log_ratios(gl, 0.001)
    K, kt = fb.K, fb.K_pad // splits
    mx = fbk.fb_max_tiled(dl, words, K, kt)
    assert ((mx - fbk.fb_max_tiled_plain(dl, words, K, kt)).abs()
            <= fbk.max_tiled_tolerance(dl, fb.nGrids)).all()
    fwd = fbk.fb_forward_tiled(dl, words, trans2, mx, K, kt)
    ck_r, S_r, lg_r = fbk.fb_forward_tiled_plain(dl, words, trans2, mx, K, kt)
    torch.testing.assert_close(fwd[0], ck_r, rtol=1e-5, atol=1e-30)
    torch.testing.assert_close(fwd[1], S_r, rtol=1e-5, atol=0)
    torch.testing.assert_close(fwd[2], lg_r, rtol=1e-5, atol=1e-2)
    args = (dl, words, fwd[0], trans2, thin, mx, fwd[1], K, 8, 0.001, kt)
    got = fbk.fb_backward_tiled(*args)
    _assert_tiled_backward(got, fbk.fb_backward_tiled_plain(*args), thin)
    assert torch.equal(fbk.fb_max_tiled(dl, words, K, kt), mx)
    assert all(torch.equal(a, b) for a, b in zip(fbk.fb_forward_tiled(dl, words, trans2, mx, K, kt),
                                                 fwd))
    assert all(torch.equal(a, b) for a, b in zip(fbk.fb_backward_tiled(*args), got))


def test_gibbs_chains_0_to_6_of_256_equal_a_7_chain_call(cuda):
    """Chain independence at the benchmark's largest chain batch: chains
    0-6 of a 256-chain Gibbs call (bench.gibbs's route: the whole-panel
    eMatRead, lem_subset, run_gibbs_chains) equal a 7-chain call on the same
    inputs bit for bit (labels and every per-iteration term, logc among
    them)."""
    from quilt_tpu_torch.bench import gibbs as bgibbs

    rng = np.random.default_rng(256)
    world = bgibbs.gibbs_world(rng, cuda, K=1024, nSNPs=32 * 64, Ksub=600)
    state = bgibbs.gibbs_state(world, 256, bgibbs.N_ITS, rng)
    wide = bgibbs.run_gibbs(world, state)
    narrow = bgibbs.run_gibbs(world, bgibbs.first_chains(world, state, 7))
    assert torch.equal(wide.H[:7], narrow.H)
    assert torch.equal(wide.per_it[:, :7], narrow.per_it)


def test_section_timers_time_the_device(cuda):
    """utils/log.py:SectionTimers on the card: a CUDA event at each edge of
    a section on the current stream, resolved after one synchronize, so a
    section around queued work reads its device time where the host clock
    reads the enqueue; nested sections' device times add up under their
    parent's; the root's self entry has no device time."""
    from quilt_tpu_torch.utils.log import SectionTimers

    x = torch.randn(2048, 2048, device=cuda)
    torch.cuda.synchronize()
    t = SectionTimers(True, cuda)
    with t.section("root", root=True):
        with t.section("mm"):
            for _ in range(8):
                x = x @ x.T / 2048.0
        with t.section("sleep"):
            torch.cuda._sleep(50_000_000)
    assert len(t._pending) == 3
    d = t.as_dict()
    assert t._pending == [] and "device_seconds" not in d["root.self"]
    dev = {k: d[k]["device_seconds"] for k in ("root", "mm", "sleep")}
    assert dev["sleep"] > 0.005 and dev["sleep"] > 10 * d["sleep"]["seconds"]
    assert dev["mm"] > 0
    assert dev["root"] >= 0.999 * (dev["mm"] + dev["sleep"])
    off = SectionTimers(False, cuda)
    with off.section("root", root=True):
        torch.cuda._sleep(1_000)
    assert off.as_dict() == {} and off._pending == []
