"""Block Gibbs at the static map boundaries in the port
(block_gibbs_boundary_detection="map", or max_block_gibbs_boundaries=0):
the boundaries of engine.context.detect_boundaries, shared by every chain,
go through the composed moves of the on-the-fly path broadcast to [NB, B].

Against the JAX package on the same numpy-seeded inputs:
- the move alone: kernels.gibbs.suffix_pair_composed at broadcast
  boundaries vs the sequential static move _block_moves_padded (rtol 1e-5,
  atol 1e-6, as tests/test_block_otf.py holds the JAX composed form), and
  nipt_block_within at broadcast boundaries vs the JAX function given the
  1-D boundaries (labels and classes equal, lemg / alpha / beta as
  tests/test_torch_nipt.py holds the move);
- the whole Gibbs call (diploid; NIPT at nl = 3 with the label resample and
  the entire relabelling) vs run_gibbs_chains on its Pallas path
  (interpreted) with the same uniforms: labels agree on > 99.5% of reads,
  dosages atol 5e-3, per-iteration likelihoods rtol 1e-4 / atol 1e-3;
- the engine on the hot-map world of
  tests/test_block_otf.py:test_pse_parity_hot_map: r2 within 0.02 of the
  JAX engine's, PSE < 0.1 in both;
and on its own: max_block_gibbs_boundaries=0 takes the static path, the
region context of a "map" run is not reused for a "gamma" run, and the
CLI takes --block_gibbs_boundary_detection map (impute, impute2, NIPT)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from quilt_tpu.config import ImputeConfig as JaxConfig
from quilt_tpu.engine import quilt_impute as jax_impute
from quilt_tpu.io import simulate_panel, simulate_sample_reads
from quilt_tpu.io.simulate import simulate_truth_mosaic
from quilt_tpu.kernels import PaddedReads as JaxPaddedReads
from quilt_tpu.kernels import emissions as jem
from quilt_tpu.kernels import gibbs as jg
from quilt_tpu.kernels import nipt as jnipt
from quilt_tpu.kernels.gibbs_pallas import _block_moves_padded
from quilt_tpu.oracle.block_gibbs import detect_boundaries as jax_detect_boundaries
from quilt_tpu.out.bgzf import bgzf_open
from quilt_tpu.out.metrics import calculate_pse, r2_simple
from quilt_tpu.panel import assign_positions_to_grid, prepare_panel, trans_rates
from quilt_tpu.panel.prepare import make_smoothed_rate
from quilt_tpu.utils import pack_bits_32

from quilt_tpu_torch import cli
from quilt_tpu_torch.config import ImputeConfig
from quilt_tpu_torch.engine import driver
from quilt_tpu_torch.engine.context import detect_boundaries
from quilt_tpu_torch.inputs import GibbsInputs, PaddedReads
from quilt_tpu_torch.kernels import gibbs as tg
from quilt_tpu_torch.kernels.emissions import emat_read_from_bits
from quilt_tpu_torch.panel.prepare import prepare_panel as prepare_panel_t
from quilt_tpu_torch.simulate import hot_genetic_map, random_sweep_state, write_bam_world

torch.set_num_threads(2)

FF = 0.2


def _padded_state(rng, G, W, B, K, nl):
    """The random padded state of tests/test_block_otf.py."""
    lemg = np.log(rng.random((G, nl * B, K)).astype(np.float32) + 0.1)
    beta = rng.random((G, nl * B, K)).astype(np.float32) + 0.05
    alphas = rng.random((G, nl * B, K)).astype(np.float32) + 0.05
    H_pad = rng.integers(0, nl, (G, W, B)).astype(np.int32)
    valid = rng.random((G, W, B)) < 0.7
    return lemg, beta, alphas, H_pad, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pair_move_at_static_boundaries_matches_sequential(seed):
    rng = np.random.default_rng(seed)
    G, W, B, K, K_real = 24, 3, 4, 16, 13
    lemg, beta, alphas, H_pad, valid = _padded_state(rng, G, W, B, K, 2)
    bnd = np.sort(rng.choice(np.arange(1, G), 5, replace=False)).astype(np.int32)
    block_u = rng.random((5, 3, B)).astype(np.float32)
    seq = _block_moves_padded(
        *(jnp.asarray(x) for x in (lemg, beta, alphas, H_pad, valid, bnd, block_u)),
        2, B, K_real, jnp.log(jnp.asarray([0.5, 0.5], jnp.float32)))
    bnd_t = torch.from_numpy(bnd)
    got = tg.suffix_pair_composed(
        torch.from_numpy(lemg), torch.from_numpy(beta), torch.from_numpy(alphas),
        torch.from_numpy(H_pad), bnd_t[:, None].expand(5, B),
        torch.from_numpy(block_u[:, 0]), B, K_real)
    for s, c, name in zip(seq, got, ("lemg", "beta", "alphas", "H")):
        np.testing.assert_allclose(c.numpy(), np.asarray(s), rtol=1e-5, atol=1e-6, err_msg=name)
    assert (got[3].numpy() != H_pad).any()              # some suffix was swapped


def _nipt_state(seed, G=9, B=3, W=5, K=24, K_real=20):
    """A random NIPT sweep state with classes (tests/test_torch_nipt.py)."""
    rng = np.random.default_rng(seed)
    lemg, beta, lem_pad, slots, first, lab, trans, cnt = random_sweep_state(
        rng, G, B, W, K, K_real, W, nl=3)
    valid = slots[:, 3] >= 0
    Hc = np.where(valid, rng.integers(0, 8, valid.shape), 0).astype(np.int32)
    return dict(lemg=lemg, beta=beta, lem_pad=lem_pad, slots=slots, first=first, trans=trans,
                valid=valid, H=slots[:, 1], Hc=Hc, rng=rng, dims=(G, B, W, K, K_real))


@pytest.mark.parametrize("resample", [True, False])
def test_nipt_within_at_static_boundaries_matches_jax(resample):
    st = _nipt_state(11 + resample)
    G, B, W, K, K_real = st["dims"]
    rng = st["rng"]
    rlc = jnipt.make_rlc(FF).astype(np.float32)
    clp = jnipt.class_log_p(FF).astype(np.float32)
    perm_mask = np.ones(6, np.float32)
    bnd = np.array([2, 5, 7], dtype=np.int32)
    block_u = rng.random((3, 3, B)).astype(np.float32)
    ru = rng.random((G, W, B)).astype(np.float32) if resample else None

    j = {k: jnp.asarray(v) for k, v in st.items() if isinstance(v, np.ndarray)}
    to4 = lambda a: jnp.transpose(a.reshape(G, 3, B, K), (0, 2, 1, 3))
    from4 = lambda a: np.asarray(jnp.transpose(a, (0, 2, 1, 3)).reshape(G, 3 * B, K))

    def rebuild(Hn):
        oh = jnp.asarray(np.eye(3, dtype=np.float32))[Hn.reshape(G, W, B)] * j["valid"][..., None]
        return jnp.transpose(jnp.einsum("gwbn,gwbk->gnbk", oh, j["lem_pad"]), (0, 2, 1, 3))

    wif = jnp.broadcast_to(jnp.repeat(jnp.arange(G, dtype=jnp.int32), W)[None, :], (B, G * W))
    ref = jg.nipt_block_within(
        to4(j["lemg"]), to4(j["beta"]), j["H"].reshape(G * W, B), j["Hc"].reshape(G * W, B),
        wif, jnp.transpose(j["valid"].reshape(G * W, B)), None, jnp.transpose(j["trans"]),
        jnp.asarray(bnd), jnp.asarray(block_u), jnp.asarray(clp), jnp.asarray(perm_mask),
        jnp.asarray(rlc), K_real,
        resample_u_it=None if ru is None else jnp.transpose(jnp.asarray(ru).reshape(G * W, B)),
        rebuild_fn=rebuild)

    t = {k: torch.from_numpy(v) for k, v in st.items() if isinstance(v, np.ndarray)}
    got = tg.nipt_block_within(
        t["lemg"], t["beta"], t["H"], t["Hc"], t["valid"], t["lem_pad"], t["slots"], t["first"],
        t["trans"], torch.from_numpy(bnd)[:, None].expand(3, B), torch.from_numpy(block_u),
        torch.from_numpy(clp), torch.from_numpy(perm_mask), torch.from_numpy(rlc), K_real,
        resample_u_it=None if ru is None else torch.from_numpy(ru))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]).reshape(G, W, B))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]).reshape(G, W, B))
    np.testing.assert_allclose(got[0].numpy(), from4(ref[0]), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got[2].numpy(), from4(ref[2]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), from4(ref[1]), rtol=1e-4, atol=1e-6)
    assert (got[3].numpy() != st["H"]).any()


def _static_boundaries(rng, G):
    """Static boundaries of a random smoothed rate over the grids (its top
    30%), from the port's detector (equal to the JAX oracle's)."""
    smooth = rng.random(G - 1) ** 4
    bnd = detect_boundaries(smooth, 0.7)
    np.testing.assert_array_equal(bnd, jax_detect_boundaries(smooth, 0.7))
    assert len(bnd) >= 2
    return bnd.astype(np.int32)


@pytest.mark.parametrize("iterative", [True, False])
def test_gibbs_call_at_static_boundaries_matches_jax(iterative, monkeypatch):
    rng = np.random.default_rng(61 + iterative)
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
    gin = jg.GibbsInputs.build_batched(reads, trans, nGrids).repeat_rows(C)
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
    bnd = _static_boundaries(rng, nGrids)
    n_its, NB = 8, len(bnd)
    uniforms = rng.random((n_its, B, gin.R)).astype(np.float32)
    H0 = rng.integers(0, 2, size=(B, gin.R)).astype(np.int32)
    first = np.array([rng.integers(0, reads[b // C].nReads) for b in range(B)], np.int32)
    block_u = rng.random((n_its, NB, 3, B)).astype(np.float32)
    do_block = np.zeros(n_its, bool)
    do_block[[2, 5]] = True

    monkeypatch.setenv("QUILT_TPU_GIBBS", "pallas")
    ref = jg.run_gibbs_chains(
        bits=words[which], preads=pr, inputs=gin, uniforms=uniforms, H0=H0,
        first_read=first, n_latent=2, ff=0.0, n_burn_in=n_its - 1,
        iterative_init=iterative, K_real=Ksub, boundaries=bnd, block_u=block_u,
        do_block=do_block, lem_read=(lem, skip))
    port_in = GibbsInputs.build_batched(reads, trans, nGrids).repeat_rows(C)
    swaps = []
    parity = tg.pair_swap_parity
    monkeypatch.setattr(tg, "pair_swap_parity",
                        lambda *a: swaps.append(parity(*a)) or swaps[-1])
    got = tg.run_gibbs_chains(
        tg.SlotLayout.build(port_in, B, "cpu"), torch.from_numpy(port_in.trans.T.copy()),
        torch.from_numpy(np.array(lem)), torch.from_numpy(np.array(skip)),
        torch.from_numpy(uniforms), torch.from_numpy(H0), torch.from_numpy(first),
        iterative, Ksub, block_u=torch.from_numpy(block_u), do_block=do_block,
        words=torch.from_numpy(words[which]), boundaries=torch.from_numpy(bnd))
    live = np.asarray(gin.read_mask)
    agree = (got.H.numpy()[live] == ref[3][live]).mean()
    assert agree > 0.995, f"label agreement {agree}"
    dos = lambda gp: gp[:, 1, :nSNPs] + 2 * gp[:, 2, :nSNPs]
    np.testing.assert_allclose(dos(got.gp.numpy()), dos(ref[0]), atol=5e-3)
    np.testing.assert_allclose(got.per_it.numpy(), ref[4], rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(got.underflow.numpy(), ref[5])
    # both block sweeps moved at the static boundaries, and some chain swapped
    assert len(swaps) == 2 and any(p.any() for p in swaps)


@pytest.mark.parametrize("entire", [False, True])
def test_nipt_gibbs_call_at_static_boundaries_matches_jax(entire, monkeypatch):
    rng = np.random.default_rng(27 + entire)
    K, nSNPs, B = 24, 320, 2
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs, region_span=200_000)
    grid, L_grid, nGrids = assign_positions_to_grid(pos)
    truth = simulate_truth_mosaic(rng, haps, n_latent=3)
    r, _ = simulate_sample_reads(rng, truth, pos, grid, coverage=3.0, read_length_bp=600,
                                 phred=25, ff=FF)
    reads = [r.sorted_by_grid()] * B
    trans = trans_rates(np.full(nGrids - 1, 0.985))
    words = pack_bits_32(haps).view(np.int32)
    bits = np.broadcast_to(words[None], (B,) + words.shape).copy()
    gin = jg.GibbsInputs.build_batched(reads, trans, nGrids)
    bnd = _static_boundaries(rng, nGrids)
    n_its, NB, R = 6, len(bnd), gin.R
    uniforms = rng.random((n_its, B, R)).astype(np.float32)
    H0 = rng.choice(3, size=(B, R), p=jnipt.nipt_prior(FF)).astype(np.int32)
    first = rng.integers(0, reads[0].nReads, B).astype(np.int32)
    block_u = rng.random((n_its, NB, 3, B)).astype(np.float32)
    resample_u = rng.random((n_its, B, R)).astype(np.float32)
    relabel_u = rng.random((n_its, B)).astype(np.float32) if entire else None
    do_block = np.zeros(n_its, bool)
    do_block[[2, 4]] = True

    monkeypatch.setenv("QUILT_TPU_GIBBS", "pallas")
    ref = jg.run_gibbs_chains(
        bits=bits, preads=JaxPaddedReads.build_batched(reads, ref_error=0.001), inputs=gin,
        uniforms=uniforms, H0=H0, first_read=first, n_latent=3, ff=FF, n_burn_in=n_its - 1,
        iterative_init=True, K_real=K, boundaries=bnd, block_u=block_u, do_block=do_block,
        resample_u=resample_u, relabel_u=relabel_u, do_entire=entire)

    port_in = GibbsInputs.build_batched(reads, trans, nGrids)
    pr = PaddedReads.build_batched(reads, ref_error=0.001)
    w_t = torch.from_numpy(bits)
    em = emat_read_from_bits(w_t, torch.from_numpy(pr.u_pad), torch.from_numpy(pr.lr),
                             torch.from_numpy(pr.la), 1e10, R_out=port_in.R)
    got = tg.run_gibbs_chains(
        tg.SlotLayout.build(port_in, B, "cpu"), torch.from_numpy(port_in.trans.T.copy()),
        torch.log(em), (em.amax(1) - em.amin(1)) <= 1e-9, torch.from_numpy(uniforms),
        torch.from_numpy(H0), torch.from_numpy(first), True, K,
        block_u=torch.from_numpy(block_u), do_block=do_block, words=w_t, ref_error=0.001,
        nl=3, ff=FF, resample_u=torch.from_numpy(resample_u),
        relabel_u=None if relabel_u is None else torch.from_numpy(relabel_u),
        boundaries=torch.from_numpy(bnd))
    nr = reads[0].nReads
    assert not got.underflow.any() and not ref[5].any()
    assert (got.H.numpy()[:, :nr] == ref[3][:, :nr]).mean() > 0.995
    assert (got.H.numpy() == 2).any()
    dos = lambda gp: gp[:, 1, :nSNPs] + 2 * gp[:, 2, :nSNPs]
    np.testing.assert_allclose(dos(got.gp.numpy()), dos(ref[0]), atol=5e-3)
    np.testing.assert_allclose(dos(got.gpF.numpy()), dos(ref[1]), atol=5e-3)
    np.testing.assert_allclose(got.per_it.numpy(), ref[4], rtol=1e-4, atol=1e-3)
    assert (got.H_class.numpy()[:, :nr] == ref[6][:, :nr]).mean() > 0.98


def test_engine_map_matches_jax_on_hot_map():
    """The world of tests/test_block_otf.py:test_pse_parity_hot_map (K 120,
    2,048 SNPs, 15x hotspots, one sample at 4x), one seek iteration of 3
    sweeps with a block move at the second, through both engines."""
    rng = np.random.default_rng(7)
    K, nSNPs = 120, 2048
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs)
    kw = dict(chrom="chr20", pos=pos, ref_allele=np.array(["A"] * nSNPs),
              alt_allele=np.array(["G"] * nSNPs), haps=haps, nMaxDH=64, gmap_pos=pos,
              gmap_cm=hot_genetic_map(nSNPs), nGen=1000)
    prep_j, prep_t = prepare_panel(**kw), prepare_panel_t(**kw)
    truth = simulate_truth_mosaic(rng, haps, n_latent=2)
    reads, _ = simulate_sample_reads(rng, truth, pos, prep_j.grid, coverage=4.0,
                                     read_length_bp=600, phred=28)
    opts = dict(nGibbsSamples=3, n_seek_its=1, n_burn_in_seek_its=0, Ksubset=80, Knew=80,
                small_ref_panel_gibbs_iterations=2, small_ref_panel_block_gibbs_iterations=[2],
                seed=7, block_gibbs_boundary_detection="map",
                override_default_params_for_small_ref_panel=False, verbose=False)
    ctx = driver._region_context(prep_t, ImputeConfig(**opts), "cpu")
    assert ctx.smooth_w is None and ctx.block_slots() == len(ctx.boundaries) >= 5
    smooth = make_smoothed_rate(prep_j.sigma, prep_j.L_grid, 5000)
    np.testing.assert_array_equal(ctx.boundaries, jax_detect_boundaries(smooth, 0.9))
    out_t = driver.quilt_impute(prep_t, [reads], ["S0"], ImputeConfig(**opts), "cpu")
    out_j = jax_impute(prep_j, [reads], ["S0"], JaxConfig(**opts))
    tg_ = truth.sum(axis=0).astype(float)
    r2 = [r2_simple(tg_, o.results[0].dosage) for o in (out_t, out_j)]
    pse = [calculate_pse(o.results[0].phased_haps[:2].T, truth.T)["pse"] for o in (out_t, out_j)]
    assert abs(r2[0] - r2[1]) < 0.02, r2
    assert max(pse) < 0.1, pse


@pytest.fixture(scope="module")
def small_world():
    rng = np.random.default_rng(5)
    K, nSNPs = 60, 320
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs, region_span=60_000)
    prep = prepare_panel_t(chrom="chr20", pos=pos, ref_allele=np.array(["A"] * nSNPs),
                           alt_allele=np.array(["G"] * nSNPs), haps=haps, nMaxDH=64,
                           gmap_pos=pos, gmap_cm=hot_genetic_map(nSNPs), nGen=1000)
    samples, truths = [], []
    for _ in range(2):
        truth = simulate_truth_mosaic(rng, haps, n_latent=2)
        r, _ = simulate_sample_reads(rng, truth, pos, prep.grid, coverage=2.0,
                                     read_length_bp=400, phred=25)
        samples.append(r)
        truths.append(truth)
    return prep, samples, np.stack([t.sum(0) for t in truths], 1).astype(float)


_SMALL = dict(nGibbsSamples=2, n_seek_its=2, Ksubset=40, Knew=40, sample_batch=2,
              small_ref_panel_gibbs_iterations=3, small_ref_panel_block_gibbs_iterations=[2, 4],
              seed=3, verbose=False,
              override_default_params_for_small_ref_panel=False)


@pytest.mark.parametrize("opts", [{"max_block_gibbs_boundaries": 0},
                                  {"block_gibbs_boundary_detection": "map"}],
                         ids=["cap0", "map"])
def test_static_options_take_the_static_path(small_world, opts, monkeypatch):
    """Both options give the static boundaries to every Gibbs call of the
    batched engine, and the calls move blocks at them."""
    prep, samples, truth_gen = small_world
    cfg = ImputeConfig(**_SMALL, **opts)
    seen = []
    move = tg.suffix_pair_composed

    def spy(lemg, beta, alphas, H_pad, bnd_rb, *a):
        seen.append(bnd_rb.clone())
        return move(lemg, beta, alphas, H_pad, bnd_rb, *a)

    monkeypatch.setattr(tg, "suffix_pair_composed", spy)
    out = driver.quilt_impute(prep, samples, ["a", "b"], cfg, "cpu", truth_gen=truth_gen)
    ctx = driver._region_context(prep, cfg, "cpu")
    assert ctx.smooth_w is None and len(ctx.boundaries) > 0
    # 2 block sweeps a call, 2 seek + 2 phasing calls
    assert len(seen) == 8
    for bnd_rb in seen:
        assert (bnd_rb == torch.from_numpy(ctx.boundaries).to(bnd_rb.dtype)[:, None]).all()
    assert min(out.r2_per_sample) > 0.9, out.r2_per_sample


def test_region_context_of_map_is_not_reused_for_gamma(small_world):
    prep = small_world[0]
    a = driver._region_context(prep, ImputeConfig(**_SMALL, block_gibbs_boundary_detection="map"),
                               "cpu")
    b = driver._region_context(prep, ImputeConfig(**_SMALL), "cpu")
    c = driver._region_context(prep, ImputeConfig(**_SMALL, max_block_gibbs_boundaries=0), "cpu")
    assert a.smooth_w is None and b.smooth_w is not None and c.smooth_w is None
    assert a is not b and c is not b
    assert b.block_slots() == b.block_nb_cap and a.block_slots() == len(a.boundaries)
    # the static boundaries are built in every mode (the block Gibbs plot reads them)
    np.testing.assert_array_equal(a.boundaries, b.boundaries)


def test_per_sample_engine_at_map(small_world):
    """A lone sample (the per-sample engine), diploid, at static boundaries."""
    prep, samples, truth_gen = small_world
    out = driver.quilt_impute(prep, samples[:1], ["a"], ImputeConfig(
        **_SMALL, block_gibbs_boundary_detection="map"), "cpu", truth_gen=truth_gen[:, :1])
    assert out.r2_per_sample[0] > 0.9, out.r2_per_sample


@pytest.mark.parametrize("verb", ["impute", "impute2", "nipt"])
def test_cli_takes_map(tmp_path, verb):
    nipt = verb == "nipt"
    vcf, gmap, bamlist, truths, nSNPs = write_bam_world(
        str(tmp_path), np.random.default_rng(8), n_samples=1 if nipt else 2,
        ff=FF if nipt else None, coverage=1.5, nSNPs=256)
    outdir = str(tmp_path / "out")
    argv = [verb if not nipt else "impute", "--outputdir", outdir, "--chr", "chr20",
            "--bamlist", bamlist, "--reference_vcf_file", vcf, "--genetic_map_file", gmap,
            "--nGibbsSamples", "2", "--n_seek_its", "1", "--Ksubset", "48", "--Knew", "48",
            "--small_ref_panel_gibbs_iterations", "2", "--small_ref_panel_block_gibbs_iterations",
            "2", "--block_gibbs_boundary_detection", "map", "--verbose", "FALSE"]
    if nipt:
        ff = tmp_path / "ff.txt"
        ff.write_text(f"{FF}\n")
        argv += ["--method", "nipt", "--fflist", str(ff)]
    assert cli.main(argv, device="cpu") == 0
    body = [l for l in bgzf_open(f"{outdir}/quilt.chr20.vcf.gz") if not l.startswith("#")]
    assert len(body) == nSNPs
    if nipt:
        ds = np.array([float(l.split("\t")[9].split(":")[2]) for l in body])
        truth = (truths[0][0] + truths[0][1]).astype(float)
        assert r2_simple(truth, ds) > 0.8
    else:
        for i in range(2):
            ds = np.array([float(l.split("\t")[9 + i].split(":")[2]) for l in body])
            assert r2_simple(truths[i].sum(axis=0).astype(float), ds) > 0.85
