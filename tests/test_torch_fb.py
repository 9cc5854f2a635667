"""Plain PyTorch full-panel FB (quilt_tpu_torch.kernels.fb) vs the JAX
package's fused Pallas FB (fb_pallas_core, interpreted on the CPU) and vs
the float64 oracle haploid_dosage_versus_refs.

Tolerances: dosage atol 1e-4; log-likelihood within 1e-2 (a sum of ~10
float32 logs per grid); top-K values atol 1e-4, with indices equal wherever
neighbouring values differ by more than 1e-3 (near-ties may swap); the
captured gamma atol 1e-5 (normalised float32 values of at most 1, the
Pallas path's bf16 hi/lo split ~2e-6 from float64)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from quilt_tpu.io import simulate_panel, simulate_sample_reads
from quilt_tpu.io.simulate import simulate_truth_mosaic
from quilt_tpu.kernels import FBInputs as JaxFBInputs
from quilt_tpu.kernels.fb_pallas import fb_pallas_core
from quilt_tpu.oracle import haploid_dosage_versus_refs, make_gl_from_reads
from quilt_tpu.panel import assign_positions_to_grid, compress_panel, trans_rates
from quilt_tpu.utils import pack_bits_32

from quilt_tpu_torch.inputs import FB_FIELDS, FBInputs, fb_inputs_from_reference
from quilt_tpu_torch.kernels.fb import fb_core, fb_full_batched, fb_plan

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(7)
    K, nSNPs, nMaxDH = 90, 333, 8
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs)
    grid, L_grid, nGrids = assign_positions_to_grid(pos)
    panel = compress_panel(pack_bits_32(haps), nSNPs, ref_error=0.001, nMaxDH=nMaxDH)
    trans = trans_rates(rng.uniform(0.95, 0.999, nGrids - 1))
    truth = simulate_truth_mosaic(rng, haps, n_latent=2)
    reads, sim = simulate_sample_reads(
        rng, truth, pos, grid, coverage=2.0, read_length_bp=1500, phred=25
    )
    gls = [make_gl_from_reads(reads, np.flatnonzero(sim.labels == h), nSNPs)
           for h in (0, 1)]
    thinned = np.array([1, 4, 8])
    ref = JaxFBInputs.build(panel, trans, thinned_grids=thinned)
    return panel, trans, np.stack(gls).astype(np.float32), ref, thinned


def test_fb_inputs_match_reference(world):
    panel, trans, _, ref, thinned = world
    got = FBInputs.build(panel, trans, thinned_grids=thinned)
    bridged = fb_inputs_from_reference({k: getattr(ref, k) for k in FB_FIELDS})
    for k in FB_FIELDS:
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))
        np.testing.assert_array_equal(getattr(bridged, k), getattr(ref, k))


def test_fb_matches_pallas(world):
    _, _, gl, ref, thinned = world
    fb = fb_inputs_from_reference({k: getattr(ref, k) for k in FB_FIELDS})
    B = gl.shape[0]
    gl_pad = np.ones((B, 2, ref.S), dtype=np.float32)
    gl_pad[:, :, :gl.shape[2]] = gl
    dev = ref.device()
    d_ref, l_ref, tv_ref, ti_ref, _ = (np.asarray(x) for x in fb_pallas_core(
        jnp.asarray(gl_pad), dev["words"], dev["trans2"], dev["thin_flag"],
        dev["capture_flag"], K=ref.K, K_pad=ref.K_pad, K_top=8,
        ref_error=0.001, CG=16, interpret=True,
    ))
    d, ll, tv, ti = (x.numpy() for x in fb_full_batched(
        torch.from_numpy(gl), fb, K_top=8, ref_error=0.001))
    np.testing.assert_allclose(d, d_ref, atol=1e-4)
    np.testing.assert_allclose(ll, l_ref, atol=1e-2)
    g = np.flatnonzero(ref.thin_flag >= 0)
    np.testing.assert_allclose(tv[g], tv_ref[g], atol=1e-4)
    firm = (tv_ref[g, :, :-1] - tv_ref[g, :, 1:]) > 1e-3
    assert firm.any()
    np.testing.assert_array_equal(ti[g, :, :-1][firm], ti_ref[g, :, :-1][firm])
    others = ref.thin_flag < 0
    assert not tv[others].any() and not ti[others].any()


def test_fb_matches_oracle(world):
    panel, trans, gl, ref, _ = world
    fb = FBInputs.build(panel, trans)
    d, ll, _, _ = fb_full_batched(torch.from_numpy(gl), fb, K_top=8,
                                  ref_error=0.001)
    for h in range(2):
        orc = haploid_dosage_versus_refs(
            gl[h].astype(np.float64), panel, trans, ref_error=0.001
        )
        np.testing.assert_allclose(d[h, :panel.nSNPs].numpy(), orc.dosage, atol=1e-4)
        assert abs(float(ll[h]) - orc.log_like) < 1e-2


def test_fb_row_chunks_are_exact(world, monkeypatch):
    """The H100 plan splits rows across calls; rows are independent."""
    import quilt_tpu_torch.kernels.fb as fbm

    panel, trans, gl, ref, thinned = world
    fb = FBInputs.build(panel, trans, thinned_grids=thinned)
    gl3 = torch.from_numpy(np.concatenate([gl, gl[:1]]))
    whole = fb_full_batched(gl3, fb, K_top=8)
    monkeypatch.setattr(fbm, "_CALL_BYTES", 1)
    assert fbm.fb_plan(3, fb) == ("fused", 1, 1)
    split = fb_full_batched(gl3, fb, K_top=8)
    # the CPU matmul may block a 3-row and a 1-row product differently,
    # so allow one float32 rounding step
    for a, b in zip(whole, split):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_fb_refuses_gamma_capture(world):
    """Only the fused family captures gamma, as on the TPU: forcing the
    K-split family on a capturing call raises; left to fb_plan, the call
    stays fused and returns the capture as a fifth output."""
    panel, trans, gl, _, _ = world
    fb = FBInputs.build(panel, trans, capture_grid=3)
    with pytest.raises(NotImplementedError, match="HLA"):
        fb_full_batched(torch.from_numpy(gl), fb, family="tiled", splits=2)
    assert fb_plan(2, fb, capture=True)[0] == "fused"
    assert fb_full_batched(torch.from_numpy(gl), fb, K_top=8)[4].shape == (2, fb.K)


@pytest.mark.parametrize("capture_grid", [5, 0])
def test_fb_capture_matches_pallas(world, capture_grid):
    """fb_core with the capture flag at one grid against the interpreted
    Pallas fb_pallas_core (gcap atol 1e-5, each row a distribution over the
    K haplotypes within 1e-5, zero at padded haplotypes); the other outputs
    equal those of the same call without capture."""
    panel, trans, gl, _, thinned = world
    ref = JaxFBInputs.build(panel, trans, thinned_grids=thinned)
    ref.capture_grid = capture_grid
    fb = fb_inputs_from_reference({k: getattr(ref, k) for k in FB_FIELDS})
    assert fb.capture_grid == capture_grid
    gl_pad = np.ones((gl.shape[0], 2, ref.S), dtype=np.float32)
    gl_pad[:, :, :gl.shape[2]] = gl
    dev = ref.device()
    *_, g_ref = (np.asarray(x) for x in fb_pallas_core(
        jnp.asarray(gl_pad), dev["words"], dev["trans2"], dev["thin_flag"],
        dev["capture_flag"], K=ref.K, K_pad=ref.K_pad, K_top=8,
        ref_error=0.001, CG=16, interpret=True,
    ))
    t = fb.device_tensors("cpu")
    args = (torch.from_numpy(gl_pad), t["words"], t["trans2"], t["thin_flag"], fb.K, 8, 0.001)
    got = fb_core(*args, cap=t["capture_flag"])
    gcap = got[4].numpy()
    np.testing.assert_allclose(gcap, g_ref, atol=1e-5)
    np.testing.assert_allclose(gcap.sum(1), 1.0, atol=1e-5)
    assert not gcap[:, fb.K:].any() and gcap.shape == (gl.shape[0], fb.K_pad)
    for a, b in zip(got[:4], fb_core(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("CG", [8, 4])
def test_fb_matches_pallas_at_checkpoint_interval(world, CG):
    """fb_core at the fused kernels' shorter checkpoint intervals (fused_cg
    takes 8 at K_pad = 5,120 and 4 up to 13,824) against the interpreted
    Pallas fb_pallas_core at CG = 16: the checkpoint interval changes no
    result beyond rounding (same tolerances as test_fb_matches_pallas)."""
    _, _, gl, ref, _ = world
    fb = fb_inputs_from_reference({k: getattr(ref, k) for k in FB_FIELDS})
    gl_pad = np.ones((gl.shape[0], 2, ref.S), dtype=np.float32)
    gl_pad[:, :, :gl.shape[2]] = gl
    dev = ref.device()
    d_ref, l_ref, tv_ref, ti_ref, _ = (np.asarray(x) for x in fb_pallas_core(
        jnp.asarray(gl_pad), dev["words"], dev["trans2"], dev["thin_flag"],
        dev["capture_flag"], K=ref.K, K_pad=ref.K_pad, K_top=8,
        ref_error=0.001, CG=16, interpret=True,
    ))
    t = fb.device_tensors("cpu")
    d, ll, tv, ti = (x.numpy() for x in fb_core(
        torch.from_numpy(gl_pad), t["words"], t["trans2"], t["thin_flag"], fb.K, 8, 0.001, CG=CG))
    np.testing.assert_allclose(d, d_ref, atol=1e-4)
    np.testing.assert_allclose(ll, l_ref, atol=1e-2)
    g = np.flatnonzero(ref.thin_flag >= 0)
    np.testing.assert_allclose(tv[g], tv_ref[g], atol=1e-4)
    firm = (tv_ref[g, :, :-1] - tv_ref[g, :, 1:]) > 1e-3
    np.testing.assert_array_equal(ti[g, :, :-1][firm], ti_ref[g, :, :-1][firm])


@pytest.fixture(scope="module")
def world_last_grid():
    """512 SNPs = 16 grids: the last real grid is the global last grid
    (beta = 1: the reverse step with stay 0 and c*se 1), with no padding."""
    rng = np.random.default_rng(11)
    K, nSNPs = 60, 512
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs)
    grid, _, nGrids = assign_positions_to_grid(pos)
    panel = compress_panel(pack_bits_32(haps), nSNPs, ref_error=0.001, nMaxDH=8)
    trans = trans_rates(rng.uniform(0.95, 0.999, nGrids - 1))
    truth = simulate_truth_mosaic(rng, haps, n_latent=2)
    reads, sim = simulate_sample_reads(rng, truth, pos, grid, coverage=2.0,
                                       read_length_bp=1500, phred=25)
    gls = [make_gl_from_reads(reads, np.flatnonzero(sim.labels == h), nSNPs) for h in (0, 1)]
    return panel, trans, np.stack(gls).astype(np.float32)


def test_fb_last_grid_is_the_beta_one_case(world_last_grid):
    """Every grid's dosage, the last (beta = 1) among them, against the
    float64 oracle (atol 1e-4), and the gamma captured at the last grid
    against the interpreted Pallas capture (atol 1e-5)."""
    panel, trans, gl = world_last_grid
    fb = FBInputs.build(panel, trans, capture_grid=panel.nGrids - 1)
    assert fb.nGrids == panel.nGrids == 16
    d, ll, _, _, gcap = fb_full_batched(torch.from_numpy(gl), fb, K_top=8, ref_error=0.001)
    for h in range(2):
        orc = haploid_dosage_versus_refs(gl[h].astype(np.float64), panel, trans, ref_error=0.001)
        np.testing.assert_allclose(d[h].numpy(), orc.dosage, atol=1e-4)
        np.testing.assert_allclose(d[h, -32:].numpy(), orc.dosage[-32:], atol=1e-4)
        assert abs(float(ll[h]) - orc.log_like) < 1e-2
    ref = JaxFBInputs.build(panel, trans)
    ref.capture_grid = panel.nGrids - 1
    dev = ref.device()
    *_, g_ref = (np.asarray(x) for x in fb_pallas_core(
        jnp.asarray(gl), dev["words"], dev["trans2"], dev["thin_flag"],
        dev["capture_flag"], K=ref.K, K_pad=ref.K_pad, K_top=8,
        ref_error=0.001, CG=16, interpret=True,
    ))
    np.testing.assert_allclose(gcap.numpy(), g_ref[:, :fb.K], atol=1e-5)


def test_fb_plain_version_at_large_k():
    """The plain version (fb_core on CPU tensors) at a K_pad (14,080) past
    what the backward kernel holds in shared memory, with fused_cg's
    fallback interval of 16 grids, against the float64 oracle (dosage atol
    1e-4, log-likelihood 1e-2) and the interpreted Pallas kernels (dosage
    and top-K values atol 1e-4). The kernel's global-plane storage itself
    runs only on the card (tests/test_torch_cuda.py, K = 14,000)."""
    from quilt_tpu_torch.kernels.fb import fused_cg

    rng = np.random.default_rng(13)
    K, nSNPs = 14000, 64
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs)
    grid, _, nGrids = assign_positions_to_grid(pos)
    panel = compress_panel(pack_bits_32(haps), nSNPs, ref_error=0.001, nMaxDH=8)
    trans = trans_rates(rng.uniform(0.95, 0.999, nGrids - 1))
    gl = rng.uniform(0.05, 1.0, (2, 2, nSNPs)).astype(np.float32)
    fb = FBInputs.build(panel, trans, thinned_grids=np.array([0, 1]))
    assert fb.K_pad == 14080 and fused_cg(fb.K_pad, fb.nGrids) == 16
    d, ll, tv, _ = fb_full_batched(torch.from_numpy(gl), fb, K_top=8, ref_error=0.001)
    for h in range(2):
        orc = haploid_dosage_versus_refs(gl[h].astype(np.float64), panel, trans, ref_error=0.001)
        np.testing.assert_allclose(d[h, :nSNPs].numpy(), orc.dosage, atol=1e-4)
        assert abs(float(ll[h]) - orc.log_like) < 1e-2
    ref = JaxFBInputs.build(panel, trans, thinned_grids=np.array([0, 1]))
    dev = ref.device()
    gl_pad = np.ones((2, 2, ref.S), dtype=np.float32)
    gl_pad[:, :, :nSNPs] = gl
    d_ref, _, tv_ref, _, _ = (np.asarray(x) for x in fb_pallas_core(
        jnp.asarray(gl_pad), dev["words"], dev["trans2"], dev["thin_flag"],
        dev["capture_flag"], K=ref.K, K_pad=ref.K_pad, K_top=8,
        ref_error=0.001, CG=16, interpret=True,
    ))
    np.testing.assert_allclose(d.numpy(), d_ref, atol=1e-4)
    np.testing.assert_allclose(tv.numpy()[:2], tv_ref[:2], atol=1e-4)
