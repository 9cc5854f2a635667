"""The K-split ("tiled") full-panel FB of the port on the CPU (plain
versions, several tiles at K = 90 through a small k_tile) against the JAX
package's K-tiled Pallas FB (fb_pallas_tiled_core, interpreted on the CPU
with K_TILE patched to 64), the float64 oracle, and the port's fused FB.

Tolerances: dosage atol 1e-4 against JAX and the oracle (the Pallas path's
bf16 hi/lo emission split is itself ~2e-6 from float64) and 1e-5 against
the port's fused path (same float32 arithmetic, sums over K taken in
another order); log-likelihood rtol 1e-4 + atol 1e-2 (a sum of ~10 float32
logs per grid); sorted top-K values atol 5e-4."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from quilt_tpu.config import ImputeConfig
from quilt_tpu.engine import quilt_impute as jax_quilt_impute
from quilt_tpu.io import simulate_panel, simulate_sample_reads
from quilt_tpu.io.simulate import simulate_truth_mosaic
from quilt_tpu.kernels import FBInputs as JaxFBInputs
from quilt_tpu.oracle import haploid_dosage_versus_refs, make_gl_from_reads
from quilt_tpu.panel import assign_positions_to_grid, compress_panel, prepare_panel, trans_rates
from quilt_tpu.utils import pack_bits_32

from quilt_tpu_torch.engine.driver import _region_context, quilt_impute
from quilt_tpu_torch.inputs import FB_FIELDS, fb_inputs_from_reference
from quilt_tpu_torch.kernels import fb as fbk

torch.set_num_threads(2)
EPS = 0.001


@pytest.fixture(scope="module")
def world():
    """The world of tests/test_fb_pallas.py: K = 90, 333 SNPs, every third
    grid thinned, 3 rows."""
    rng = np.random.default_rng(7)
    K, nSNPs, nMaxDH = 90, 333, 8
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs)
    grid, L_grid, nGrids = assign_positions_to_grid(pos)
    panel = compress_panel(pack_bits_32(haps), nSNPs, ref_error=EPS, nMaxDH=nMaxDH)
    trans = trans_rates(rng.uniform(0.95, 0.999, nGrids - 1))
    truth = simulate_truth_mosaic(rng, haps, n_latent=2)
    reads, sim = simulate_sample_reads(
        rng, truth, pos, grid, coverage=2.0, read_length_bp=1500, phred=25
    )
    gls = np.stack([make_gl_from_reads(reads, np.flatnonzero(sim.labels == h), nSNPs)
                    for h in (0, 1)]).astype(np.float32)
    ref = JaxFBInputs.build(panel, trans, thinned_grids=np.arange(0, nGrids, 3))
    gl_b = np.stack([gls[i % 2] for i in range(3)])
    gl_pad = np.ones((3, 2, ref.S), dtype=np.float32)
    gl_pad[:, :, :nSNPs] = gl_b
    fb = fb_inputs_from_reference({k: getattr(ref, k) for k in FB_FIELDS})
    return panel, trans, ref, fb, gl_pad


def _tensors(fb):
    dev = fb.device_tensors("cpu")
    return dev["words"], dev["trans2"], dev["thin_flag"]


def _tiled(fb, gl_pad, k_tile, K_top=8):
    return [x.numpy() for x in fbk.fb_tiled_core(
        torch.from_numpy(gl_pad), *_tensors(fb), fb.K, K_top, EPS, k_tile=k_tile)]


@pytest.mark.parametrize("tiles", [2, 16])
def test_tiled_matches_pallas_tiled(world, monkeypatch, tiles):
    """Two tiles of 64 and sixteen of 8 (the most blocks a row of the GPU
    form), the Pallas kernel's K_TILE patched to the same width."""
    import quilt_tpu.kernels.fb_pallas as fbp

    _, _, ref, fb, gl_pad = world
    k_tile = fb.K_pad // tiles
    monkeypatch.setattr(fbp, "K_TILE", k_tile)
    dev = ref.device()
    d_ref, l_ref, tv_ref, _, _ = (np.asarray(x) for x in fbp.fb_pallas_tiled_core(
        jnp.asarray(gl_pad), dev["words"], dev["trans2"], dev["thin_flag"],
        dev["capture_flag"], K=ref.K, K_pad=ref.K_pad, K_top=8, ref_error=EPS,
        interpret=True,
    ))
    d, ll, tv, ti = _tiled(fb, gl_pad, k_tile)
    np.testing.assert_allclose(d, d_ref, atol=1e-4)
    np.testing.assert_allclose(ll, l_ref, rtol=1e-4, atol=1e-2)
    thin = np.flatnonzero(ref.thin_flag >= 0)
    assert len(thin) > 3
    for g in thin:
        np.testing.assert_allclose(np.sort(tv[g], axis=1), np.sort(tv_ref[g], axis=1),
                                   atol=5e-4)
    others = ref.thin_flag < 0
    assert not tv[others].any() and not ti[others].any()


@pytest.mark.parametrize("k_tile", [64, 8])
def test_tiled_matches_oracle(world, k_tile):
    """Two tiles, and sixteen (the most blocks a row of the GPU form)."""
    panel, trans, _, fb, gl_pad = world
    d, ll, _, _ = _tiled(fb, gl_pad, k_tile)
    for row in range(2):
        orc = haploid_dosage_versus_refs(
            gl_pad[row, :, :panel.nSNPs].astype(np.float64), panel, trans, ref_error=EPS)
        np.testing.assert_allclose(d[row, :panel.nSNPs], orc.dosage, atol=1e-4)
        assert abs(float(ll[row]) - orc.log_like) < 1e-2


@pytest.mark.parametrize("k_tile", [32, 64, 128, 48])
def test_tiled_matches_fused(world, k_tile):
    """One tile (128), two, four, and a ragged last tile (48 into 128)."""
    _, _, _, fb, gl_pad = world
    d_f, l_f, tv_f, ti_f = (x.numpy() for x in fbk.fb_core(
        torch.from_numpy(gl_pad), *_tensors(fb), fb.K, 8, EPS))
    d, ll, tv, ti = _tiled(fb, gl_pad, k_tile)
    np.testing.assert_allclose(d, d_f, atol=1e-5)
    np.testing.assert_allclose(ll, l_f, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(tv, tv_f, atol=1e-5)
    g = fb.thin_flag >= 0
    firm = (tv_f[g][:, :, :-1] - tv_f[g][:, :, 1:]) > 1e-5
    assert firm.any()
    np.testing.assert_array_equal(ti[g][:, :, :-1][firm], ti_f[g][:, :, :-1][firm])


@pytest.mark.parametrize("CG", [2, 4, 8, 16])
@pytest.mark.parametrize("k_tile", [32, 64, 128, 48])
def test_tiled_checkpoint_intervals(world, k_tile, CG):
    """The K-split FB at each checkpoint interval of the tiled backward
    (tiled_cg gives 16, 8, 4 or 2 by block width) and tile width (one tile,
    two, four, a ragged last tile) against the float64 oracle (dosage atol
    1e-4, log-likelihood 1e-2) and the fused FB (dosage and top-K atol
    1e-5, indices equal where the gap is over 1e-5); the backward's output
    does not depend on the interval beyond rounding."""
    panel, trans, _, fb, gl_pad = world
    args = (torch.from_numpy(gl_pad), *_tensors(fb), fb.K, 8, EPS)
    d, ll, tv, ti = (x.numpy() for x in fbk.fb_tiled_core(*args, k_tile=k_tile, CG=CG))
    for row in range(2):
        orc = haploid_dosage_versus_refs(
            gl_pad[row, :, :panel.nSNPs].astype(np.float64), panel, trans, ref_error=EPS)
        np.testing.assert_allclose(d[row, :panel.nSNPs], orc.dosage, atol=1e-4)
        assert abs(float(ll[row]) - orc.log_like) < 1e-2
    d_f, l_f, tv_f, ti_f = (x.numpy() for x in fbk.fb_core(*args))
    np.testing.assert_allclose(d, d_f, atol=1e-5)
    np.testing.assert_allclose(ll, l_f, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(tv, tv_f, atol=1e-5)
    g = fb.thin_flag >= 0
    firm = (tv_f[g][:, :, :-1] - tv_f[g][:, :, 1:]) > 1e-5
    assert firm.any()
    np.testing.assert_array_equal(ti[g][:, :, :-1][firm], ti_f[g][:, :, :-1][firm])


def _nibble_logit_max(dl, words, g, K):
    """[B] max over the K haplotypes of grid g's emission logit, in numpy
    float32 in the kernels' order of additions (fb_common.cuh): per nibble
    of the panel word its set bits' log-ratios in bit order, then the 8
    nibble sums in order."""
    d = dl[:, g * 32:(g + 1) * 32].numpy()
    w = words[g, :K].numpy().astype(np.int64) & 0xFFFFFFFF
    bits = ((w[None, :] >> np.arange(32)[:, None]) & 1).astype(bool)      # [32, K]
    tot = None
    for q in range(8):
        nib = np.zeros((d.shape[0], K), np.float32)
        for s in range(4 * q, 4 * q + 4):
            nib = np.where(bits[s][None, :], nib + d[:, s:s + 1], nib)
        tot = nib if tot is None else tot + nib
    return torch.from_numpy(tot.max(1))


def _nibble_sums(d, w):
    """[8, B, K] numpy float32 nibble sums of the panel words w [K] under
    the log-ratios d [B, 32]: the set bits' log-ratios in bit order."""
    bits = ((w[None, :] >> np.arange(32)[:, None]) & 1).astype(bool)      # [32, K]
    out = []
    for q in range(8):
        nib = np.zeros((d.shape[0], w.shape[0]), np.float32)
        for s in range(4 * q, 4 * q + 4):
            nib = np.where(bits[s][None, :], nib + d[:, s:s + 1], nib)
        out.append(nib)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_byte_order_within_max_tiled_tolerance(seed):
    """fb_max_tiled adds a logit's nibble sums by byte pairs and then bytes
    ((n0 + n1) + (n2 + n3)) + ... where the plain version adds them in
    nibble order; both orders, in numpy float32, give maxima within
    max_tiled_tolerance of each other (large log-ratios of both signs, so
    that the orders do round apart)."""
    rng = np.random.default_rng(seed)
    B, Gp, K = 28, 4, 3000
    dl = torch.from_numpy(rng.normal(0, 4, (B, Gp * 32)).astype(np.float32))
    words = rng.integers(0, 2**32, (Gp, K), dtype=np.int64)
    tol = fbk.max_tiled_tolerance(dl, Gp)
    moved = 0
    for g in range(Gp):
        n = _nibble_sums(dl[:, g * 32:(g + 1) * 32].numpy(), words[g])
        by_nibble = n[0]
        for q in range(1, 8):
            by_nibble = by_nibble + n[q]
        b = [n[2 * q] + n[2 * q + 1] for q in range(4)]
        by_byte = ((b[0] + b[1]) + b[2]) + b[3]
        moved += int((by_byte != by_nibble).sum())
        diff = np.abs(by_byte.max(1) - by_nibble.max(1))
        assert (diff <= tol[g].numpy()).all(), (diff.max(), tol[g].min())
        # the bound holds logit by logit, not just at the maximum
        assert (np.abs(by_byte - by_nibble) <= tol[g].numpy()[:, None]).all()
    assert moved > 0


@pytest.mark.parametrize("k_tile", [32, 64, 128])
def test_tiled_stages(world, k_tile):
    """Stage by stage: the max pre-pass equals the max of the emission
    logits added in the kernels' order, and the float64 product's within
    the float32 rounding of those additions; the forward's S, checkpoints
    and log-likelihood agree with the fused forward's; the remat reproduces
    the forward's normalised alphas."""
    _, _, _, fb, gl_pad = world
    words, trans2, _ = _tensors(fb)
    dl, _ = fbk._gl_log_ratios(torch.from_numpy(gl_pad), EPS)
    mx = fbk.fb_max_tiled(dl, words, fb.K, k_tile)
    for g in (0, 3, fb.nGrids - 1):
        torch.testing.assert_close(mx[g], _nibble_logit_max(dl, words, g, fb.K),
                                   rtol=0, atol=1e-6)
        # float64 reference: each logit is 32 terms through at most 3 + 7
        # float32 additions, each rounding by at most 2^-24 of a partial
        # sum, so it lies within 10 * 2^-24 * sum |log-ratio| of the exact one
        d64 = dl[:, g * 32:(g + 1) * 32].double()
        _, mx64 = fbk._emissions(dl.double(), words, g, fb.K)
        bound = 10 * 2.0 ** -24 * d64.abs().sum(1)
        assert ((mx[g].double() - mx64[:, 0]).abs() <= bound).all()
    CG = fbk.tiled_cg(k_tile, fb.nGrids)
    assert CG == fbk.fused_cg(fb.K_pad, fb.nGrids) == 16
    ckpt, S, logs = fbk.fb_forward_tiled(dl, words, trans2, mx, fb.K, k_tile)
    ckpt_f, logs_f = fbk.fb_forward(dl, words, trans2, fb.K)
    torch.testing.assert_close(logs, logs_f, rtol=1e-5, atol=1e-3)
    for ci in range(fb.nGrids // CG):
        # checkpoint ci: unnormalised alpha entering the chunk, over S before it
        norm = S[ci * CG - 1][:, None] if ci else 1.0
        torch.testing.assert_close(ckpt[ci] / norm, ckpt_f[ci], rtol=1e-4, atol=1e-7)
        alphas = fbk.fb_remat_tiled_plain(dl, words, ckpt[ci], trans2, mx, S, ci, fb.K, k_tile,
                                          CG)
        torch.testing.assert_close(alphas.sum(-1), torch.ones_like(alphas.sum(-1)),
                                   rtol=1e-5, atol=0)
        if ci + 1 < fb.nGrids // CG:
            # the chunk's last alpha is the next checkpoint, normalised
            torch.testing.assert_close(alphas[-1], ckpt_f[ci + 1], rtol=1e-4, atol=1e-7)
        # the plain fused forward, restarted at the chunk, gives every alpha
        a = ckpt_f[ci]
        for j in range(CG):
            e, _ = fbk._emissions(dl, words, ci * CG + j, fb.K)
            a = (trans2[0, ci * CG + j] * a + trans2[1, ci * CG + j] / fb.K) * e
            a = a / a.sum(1, keepdim=True)
            torch.testing.assert_close(alphas[j], a, rtol=1e-4, atol=1e-7)


class _Shape:
    def __init__(self, K, nGrids=512):
        self.K, self.K_pad, self.nGrids = K, K, nGrids


@pytest.mark.parametrize("rows, K, family, splits", [
    (14, 5120, "tiled", 8), (28, 5120, "tiled", 4), (56, 5120, "tiled", 2),
    (84, 5120, "fused", 1), (112, 5120, "fused", 1),
    (14, 8192, "tiled", 8), (28, 8192, "tiled", 4), (56, 8192, "tiled", 2),
    (112, 8192, "tiled", 2), (200, 8192, "tiled", 2), (28, 8320, "tiled", 4),
    (28, 10240, "tiled", 4), (56, 10240, "tiled", 2), (112, 10240, "tiled", 2),
    (14, 20480, "tiled", 8), (28, 20480, "tiled", 4), (56, 20480, "tiled", 2),
    (112, 20480, "tiled", 2), (200, 20480, "tiled", 2),
    (28, 40960, "tiled", 4), (56, 40960, "tiled", 4), (112, 40960, "tiled", 4),
    (200, 40960, "tiled", 4), (2, 256, "fused", 1), (14, 4096, "fused", 1),
    (16, 98304, "tiled", 16), (16, 194560, "tiled", 16),
])
def test_fb_plan(rows, K, family, splits):
    """The plan at every shape that chip_smoke.py's "fb_plan timing" lines
    measured (PERF.md), each the fastest there: a split of 4 or 8 while the
    blocks fit about one wave (8 blocks of 640 at 14 x 5,120), of 2 beyond
    it, 4 at 40,960 (2 blocks a row there take the general form and, at
    112 rows and up, two calls; 8 lost to 4 at 28 rows once the forward
    held its alphas in registers); 16 at 16 rows x 98,304 and 194,560 (7
    clusters of 16 at once against 15 of 8, but half the haplotypes a
    block); the fused family at 5,120 once no split fits one wave (the
    QUILT1 quick-start batch of 112 rows, the NIPT batch of 84); and below
    5,120, where no split was measured. Every call here takes all its
    rows."""
    assert fbk.fb_plan(rows, _Shape(K)) == (family, rows, splits)


@pytest.mark.parametrize("rows, K, plan", [
    (112, 98304, ("tiled", 42, 8)), (112, 194560, ("tiled", 21, 16)),
    (84, 98304, ("tiled", 42, 8)), (28, 194560, ("tiled", 21, 16)),
])
def test_fb_plan_past_one_call(rows, K, plan):
    """Where the checkpoints of all rows exceed _CALL_BYTES: at 112 rows x
    98,304 the staged form at 8 blocks a row (checkpoints every 2 grids, so
    42 rows a call) was the fastest (118.36 ms against 128.09 for 16 blocks,
    whose 7 clusters at once take 16 waves); at 194,560 16 blocks in the
    staged form, 21 rows a call (245.42 ms against 394.19 for 8)."""
    assert fbk.fb_plan(rows, _Shape(K)) == plan


@pytest.mark.parametrize("KS, cg, cpt", [
    (64, 16, 2), (1024, 16, 2), (3296, 16, 8), (3312, 8, 8), (5120, 8, 16), (6752, 8, 16),
    (6768, 4, 16), (10240, 4, 20), (10248, 2, 24), (12160, 2, 24), (12288, 2, 24),
    (12296, 4, 0), (13696, 4, 0), (13712, 2, 0), (20480, 2, 0), (24320, 2, 0),
    (27552, 2, 0), (27568, 16, 0),
])
def test_tiled_cg(KS, cg, cpt):
    """The tiled backward's checkpoint interval is the largest of 16, 8, 4, 2
    whose planes fit a block's shared memory beside its tables, posts and
    32-entry top-K lists (at K_top 32 the largest call), else 16 with the
    planes in global memory; the register forms hold up to 20 haplotypes a
    thread, the staged form 24 (K = 98,304 at 8 blocks a row, 194,560 at
    16) with a word plane beside each alpha plane, so at interval 2."""
    assert fbk.tiled_cg(KS, 512) == cg
    smem, c = fbk._tiled_storage(cg, KS, 32)
    assert smem == (KS <= 27552) and c == cpt
    assert fbk._fwd_tiled_cpt(KS) == (cpt or (24 if KS <= 24 * 512 else 0))
    planes = fbk._smem_planes(c) if smem else 0
    assert fbk._bwd_tiled_smem_bytes(cg, KS, 32, planes) <= fbk._SMEM_LIMIT
    if 2 < cg < 16 and smem:
        assert fbk._bwd_tiled_smem_bytes(2 * cg, KS, 32, planes) > fbk._SMEM_LIMIT
    if c == 24:
        # the staged form's planes do not fit at 4: forced there, the block
        # takes the general form, whose alpha planes do
        assert fbk._bwd_tiled_smem_bytes(4, KS, 32, 2) > fbk._SMEM_LIMIT
        assert fbk._tiled_storage(4, KS, 32) == (True, 0)
    if smem:
        assert fbk.tiled_cg(KS, 24) == min(cg, 8)      # the interval divides Gp


@pytest.mark.parametrize("K, splits, planes", [
    (40960, 4, 512 // 4),                # registers: the checkpoints only
    (40960, 2, 512 // 2 + 1 + 1),        # general forms: + the forward's alpha plane and
                                         # the backward's e*beta plane
    (60032, 2, 512 // 16 + 1 + 1 + 16),  # + the chunk's 16 alpha planes in global memory
    (8192, 8, 512 // 16),
    (98304, 8, 512 // 2),                # the staged form: checkpoints every 2 grids
    (98304, 16, 512 // 8),               # 6,144 a block: 16 a thread, interval 8
    (194560, 16, 512 // 2),              # the TOPMed-sized panel: staged at 16 blocks
    (194560, 8, 512 // 2 + 1 + 1),       # 24,320 a block: the general forms
])
def test_fb_plan_tiled_planes(K, splits, planes):
    """fb_plan's rows per tiled call follow the backward's checkpoint
    interval: _CALL_BYTES over the planes of K_pad floats a row."""
    assert fbk._tiled_planes(K, 512, splits) == planes
    rows = fbk.fb_plan(1000, _Shape(K), family="tiled", splits=splits)[1]
    assert rows == min(1000, fbk._CALL_BYTES // (planes * K * 4))


def test_splits_accept_16_blocks_and_refuse_32():
    """A row splits into 1, 2, 4, 8 or 16 blocks (a cluster of 16 is the
    largest the card schedules, a non-portable size); 32, or a k_tile that
    does not cut K_pad, raises, in the wrappers and in fb_plan."""
    for splits in (1, 2, 4, 8, 16):
        assert fbk._splits(4096, 4096 // splits) == splits
    for k_tile in (128, 100, 3000):
        with pytest.raises(ValueError, match="k_tile"):
            fbk._splits(4096, k_tile)
    shape = _Shape(98304)
    assert fbk.fb_plan(16, shape, family="tiled", splits=16)[2] == 16
    with pytest.raises(ValueError, match="splits"):
        fbk.fb_plan(16, shape, family="tiled", splits=32)


def test_fb_plan_forced_and_capture(world):
    _, _, _, fb, gl_pad = world
    assert fbk.fb_plan(3, fb)[0] == "fused"
    assert fbk.fb_plan(3, fb, family="tiled", splits=2) == ("tiled", 3, 2)
    assert fbk.fb_plan(3, fb, family="fused", splits=4) == ("fused", 3, 1)
    with pytest.raises(ValueError):
        fbk.fb_plan(3, fb, family="xla")
    with pytest.raises(ValueError):
        fbk.fb_plan(3, fb, splits=3)
    gl = torch.from_numpy(gl_pad)
    with pytest.raises(NotImplementedError, match="HLA"):
        fbk.fb_full_batched(gl, dataclasses.replace(fb, capture_grid=3), family="tiled",
                            splits=2)
    forced = fbk.fb_full_batched(gl, fb, K_top=8, ref_error=EPS, family="tiled", splits=2)
    direct = fbk.fb_tiled_core(gl, *_tensors(fb), fb.K, 8, EPS, k_tile=fb.K_pad // 2)
    for a, b in zip(forced, direct):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_engine_tiled_matches_fused_and_jax():
    """The slice as a whole: quilt_impute with the FB plan forced to the
    tiled family gives r2 within 0.01 of the fused run's and of the JAX
    engine's on the same world."""
    rng = np.random.default_rng(11)
    K, nSNPs, N = 100, 448, 2
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs)
    prep = prepare_panel(chrom="chr20", pos=pos, ref_allele=np.array(["A"] * nSNPs),
                         alt_allele=np.array(["G"] * nSNPs), haps=haps, nMaxDH=64)
    samples, truths = [], []
    for _ in range(N):
        truth = simulate_truth_mosaic(rng, haps, n_latent=2)
        reads, _ = simulate_sample_reads(rng, truth, pos, prep.grid, coverage=1.5,
                                         read_length_bp=500, phred=25)
        samples.append(reads)
        truths.append(truth)
    truth_gen = np.stack([t.sum(axis=0) for t in truths], axis=1).astype(float)
    cfg = ImputeConfig(nGibbsSamples=3, n_seek_its=2, Ksubset=48, Knew=48,
                       small_ref_panel_gibbs_iterations=8, seed=21, sample_batch=N)
    names = ["a", "b"]
    fused = quilt_impute(prep, samples, names, cfg, "cpu", truth_gen=truth_gen)
    ctx = _region_context(prep, cfg, "cpu")
    calls = []
    core = fbk.fb_tiled_core
    ctx.fb_plan_args = dict(family="tiled", splits=2)
    try:
        fbk.fb_tiled_core = lambda *a, **k: calls.append(k["k_tile"]) or core(*a, **k)
        tiled = quilt_impute(prep, samples, names, cfg, "cpu", truth_gen=truth_gen)
    finally:
        fbk.fb_tiled_core = core
        ctx.fb_plan_args = {}
    assert calls and set(calls) == {ctx.fb_inputs.K_pad // 2}
    ref = jax_quilt_impute(prep, samples, names, cfg, truth_gen=truth_gen)
    for a, b, c in zip(tiled.r2_per_sample, fused.r2_per_sample, ref.r2_per_sample):
        assert a > 0.9
        assert abs(a - b) < 0.01, (a, b)
        assert abs(a - c) < 0.01, (a, c)


@pytest.mark.parametrize("splits", [1, 2, 4, 8, 16])
def test_tiled_forward_ragged_last_block(world, splits):
    """The forward at each split the GPU form takes (k_tile = K_pad / splits,
    so the last real block is ragged and, at 8 splits, two blocks hold only
    pad haplotypes): the pads' checkpoints stay 0, S equals the one-block
    forward's (rtol 1e-6: sums in another order), and the normalised
    checkpoints and the log-likelihood agree with the fused forward (rtol
    1e-4 / atol 1e-7; rtol 1e-5 + atol 1e-3)."""
    _, _, _, fb, gl_pad = world
    words, trans2, _ = _tensors(fb)
    assert fb.K_pad % 8 == 0 and fb.K_pad - fb.K > fb.K_pad // 8
    dl, _ = fbk._gl_log_ratios(torch.from_numpy(gl_pad), EPS)
    kt = fb.K_pad // splits
    mx = fbk.fb_max_tiled(dl, words, fb.K, kt)
    ckpt, S, logs = fbk.fb_forward_tiled(dl, words, trans2, mx, fb.K, kt)
    _, S1, _ = fbk.fb_forward_tiled(dl, words, trans2, mx, fb.K, fb.K_pad)
    assert not ckpt[..., fb.K:].any()
    torch.testing.assert_close(S, S1, rtol=1e-6, atol=0)
    ckpt_f, logs_f = fbk.fb_forward(dl, words, trans2, fb.K)
    torch.testing.assert_close(logs, logs_f, rtol=1e-5, atol=1e-3)
    CG = fbk.tiled_cg(kt, fb.nGrids)
    for ci in range(1, fb.nGrids // CG):
        torch.testing.assert_close(ckpt[ci] / S[ci * CG - 1][:, None], ckpt_f[ci],
                                   rtol=1e-4, atol=1e-7)
