"""NIPT (mother + fetus, 3 latent haplotypes) in the port against the JAX
package, on the same numpy-seeded inputs:

- compute_hclass vs _compute_Hclass_padded: classes equal on > 99.5% of the
  live slots (a read whose distance to two class rows ties within float
  rounding may take the other);
- nipt_block_within vs quilt_tpu.kernels.gibbs.nipt_block_within, called as
  the Pallas path calls it, with identical block_u / resample_u: labels and
  classes equal, lemg / alpha / beta rtol 1e-4 (float32 sums in another
  order; atol 1e-3 on lemg as in the sweep tests, 1e-6 on alpha and beta);
- entire_relabel vs _entire_probs + _apply_perm3_padded: equal;
- the block move's bank scan (kernels.nipt_bank.bank_scan_plain, the plain
  version of the bank kernel) vs a float64 numpy transcription of the JAX
  scan_step (quilt_tpu/kernels/gibbs.py, nipt_block_within): the same
  relabellings drawn, probabilities atol 1e-5 (float32 against float64 over
  a few tens of grids); a per-(grid, row) shift of lemg leaves the draws
  equal and the probabilities within 1e-5 (the shifted lemg itself rounds);
- the whole Gibbs call at nl = 3, ff = 0.2, with block moves and the label
  resample, vs run_gibbs_chains on its Pallas path (interpreted): the
  tolerances of tests/test_gibbs_pallas.py (labels > 0.995, maternal and
  fetal dosages atol 5e-3, per-iteration likelihoods rtol 1e-4 / atol 1e-3,
  classes > 0.98);
- the engine: the two-fetal-fraction world of tests/test_engine_batched.py
  (on a 60 kb region, so that a grid holds tens of reads, not hundreds, and
  the plain sweeps stay short) through both quilt_impute's (maternal
  r2 > 0.85, fetal r2 > 0.5 in both,
  and within 0.1 / 0.2 of each other: the two draw different random numbers),
  the VCF FORMAT, and a small QUILT2-NIPT world (msPBWT + rare/common);
- the CLI: `impute --method nipt --fflist` through the files on the CPU
  (one sample at 3x: FORMAT, all sites, maternal r2 > 0.8), and the error
  without --fflist."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from quilt_tpu.config import ImputeConfig as JaxConfig
from quilt_tpu.engine import quilt_impute as jax_impute
from quilt_tpu.io import simulate_panel, simulate_sample_reads
from quilt_tpu.io.simulate import simulate_truth_mosaic
from quilt_tpu.kernels import PaddedReads as JaxPaddedReads
from quilt_tpu.kernels import gibbs as jg
from quilt_tpu.kernels import gibbs_pallas as jgp
from quilt_tpu.kernels import nipt as jnipt
from quilt_tpu.out.bgzf import bgzf_open
from quilt_tpu.out.metrics import r2_simple
from quilt_tpu.panel import assign_positions_to_grid, prepare_panel, trans_rates
from quilt_tpu.panel.prepare import smoothing_band
from quilt_tpu.utils import pack_bits_32

from quilt_tpu_torch import cli
from quilt_tpu_torch.config import ImputeConfig
from quilt_tpu_torch.engine.driver import quilt_impute
from quilt_tpu_torch.inputs import GibbsInputs, PaddedReads
from quilt_tpu_torch.kernels import gibbs as tg
from quilt_tpu_torch.kernels import nipt_bank as nb
from quilt_tpu_torch.kernels.emissions import emat_read_from_bits
from quilt_tpu_torch.kernels.gibbs_sweep import CLUSTER, GENERAL, GLOBAL
from quilt_tpu_torch.panel.prepare import prepare_panel as prepare_panel_t
from quilt_tpu_torch.simulate import random_sweep_state, write_bam_world

torch.set_num_threads(2)

FF = 0.2


def _state(seed, G=9, B=3, W=5, K=24, K_real=20):
    """A random NIPT sweep state with classes, as numpy arrays."""
    rng = np.random.default_rng(seed)
    lemg, beta, lem_pad, slots, first, lab, trans, cnt = random_sweep_state(
        rng, G, B, W, K, K_real, W, nl=3)
    alphas = rng.uniform(0.0, 1.0, lemg.shape).astype(np.float32)
    alphas[..., K_real:] = 0.0
    alphas /= alphas.sum(2, keepdims=True)
    valid = slots[:, 3] >= 0
    Hc = np.where(valid, rng.integers(0, 8, valid.shape), 0).astype(np.int32)
    return dict(lemg=lemg, beta=beta, lem_pad=lem_pad, slots=slots, first=first, trans=trans,
                alphas=alphas, valid=valid, live=valid & (slots[:, 2] == 0), H=slots[:, 1],
                Hc=Hc, rng=rng, dims=(G, B, W, K, K_real))


def _tables():
    prior = jnipt.nipt_prior(FF).astype(np.float32)
    return (prior, jnipt.make_rlc(FF).astype(np.float32),
            jnipt.class_log_p(FF).astype(np.float32), np.ones(6, np.float32))


def test_nipt_tables_match():
    prior, rlc, clp, perm_mask = _tables()
    got = tg.nipt_tables_for(FF, "cpu")
    np.testing.assert_allclose(got[0], prior, rtol=1e-7)
    for a, b in zip(got[1:], (rlc, clp, perm_mask)):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(tg.nipt_tables_for(0.0, "cpu")[3].numpy(), [1, 0, 1, 0, 0, 0])


def test_hclass_matches_jax(monkeypatch):
    st = _state(3)
    prior, rlc, _, _ = _tables()
    # reads that tell the haplotypes apart: row h of chain b sits on column
    # 3b + h, and a read fits a random non-empty set of the three
    G, B, W, K, K_real = st["dims"]
    st["alphas"][:] = 1e-4
    fits = st["rng"].integers(1, 8, size=(G, W, B))
    st["lem_pad"][:] = -6.0
    for b in range(B):
        for h in range(3):
            st["alphas"][:, h * B + b, 3 * b + h] = 1.0
            st["lem_pad"][:, :, b, 3 * b + h] = np.where((fits[:, :, b] >> h) & 1, 0.0, -6.0)
    st["alphas"][..., K_real:] = 0.0
    st["beta"][:] = 1.0
    ref = np.asarray(jgp._compute_Hclass_padded(
        *(jnp.asarray(st[k]) for k in ("alphas", "beta", "lem_pad", "H", "live")),
        jnp.asarray(prior), jnp.asarray(rlc)))
    # two grids per step of the port's loop
    monkeypatch.setattr(tg, "_HCLASS_CHUNK_BYTES", 2 * W * B * K * 4)
    got = tg.compute_hclass(
        *(torch.from_numpy(st[k]) for k in ("alphas", "beta", "lem_pad", "H", "live")),
        tuple(prior), torch.from_numpy(rlc)).numpy()
    assert got.dtype == np.int32 and got.shape == ref.shape
    assert not got[~st["live"]].any()
    assert (got[st["live"]] == ref[st["live"]]).mean() > 0.995
    assert len(np.unique(ref)) >= 7, np.unique(ref)


@pytest.mark.parametrize("resample", [True, False])
def test_block_within_matches_jax(resample):
    st = _state(5 + resample)
    G, B, W, K, K_real = st["dims"]
    rng = st["rng"]
    prior, rlc, clp, perm_mask = _tables()
    NB = 3
    bnd = np.sort(np.where(rng.random((NB, B)) < 0.3, 0, rng.integers(1, G, (NB, B))),
                  axis=0).astype(np.int32)
    bnd[:, 0] = (0, 0, 0)                                 # a row without boundaries
    block_u = rng.random((NB, 3, B)).astype(np.float32)
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
        t["trans"], torch.from_numpy(bnd), torch.from_numpy(block_u), torch.from_numpy(clp),
        torch.from_numpy(perm_mask), torch.from_numpy(rlc), K_real,
        resample_u_it=None if ru is None else torch.from_numpy(ru))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]).reshape(G, W, B))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]).reshape(G, W, B))
    np.testing.assert_allclose(got[0].numpy(), from4(ref[0]), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got[2].numpy(), from4(ref[2]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), from4(ref[1]), rtol=1e-4, atol=1e-6)
    # the move did something: some block of some row was relabelled
    assert (got[3].numpy() != st["H"]).any()


def test_entire_relabel_matches_jax():
    st = _state(9)
    G, B, W, K, _ = st["dims"]
    log_prior = np.log(_tables()[0])
    u = st["rng"].random(B).astype(np.float32)
    j = {k: jnp.asarray(v) for k, v in st.items() if isinstance(v, np.ndarray)}
    oh = jnp.asarray(np.eye(3, dtype=np.float32))[jnp.clip(j["H"], 0, 2)]
    rc = (oh * j["valid"][..., None]).sum(axis=(0, 1))
    chosen = jg._sample_idx(jg._entire_probs(rc, jnp.asarray(log_prior)), jnp.asarray(u))
    ref = jgp._apply_perm3_padded(chosen, jnp.ones((G, B), bool), j["valid"], j["lemg"],
                                  j["beta"], j["alphas"], j["H"], j["Hc"])
    t = {k: torch.from_numpy(v) for k, v in st.items() if isinstance(v, np.ndarray)}
    got = tg.entire_relabel(t["lemg"], t["beta"], t["alphas"], t["H"], t["Hc"], t["valid"],
                            torch.from_numpy(log_prior), torch.from_numpy(u))
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(chosen))
    for a, b in zip(got[:5], ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _scan_step_f64(lemg, beta, trans, ht, u, is_end, perm_mask, K_real):
    """The JAX scan_step of nipt_block_within in float64 numpy, per chain the
    6 relabellings x 3 rows of the bank (aS [B, 6, 3, K]); ht stands for its
    class-count term ns_t @ clp. Returns (chosen [G, B], probs [G, B, 6]),
    0 where no block ends."""
    G, BN, K = lemg.shape
    B = BN // 3
    to4 = lambda x: x.reshape(G, 3, B, K).transpose(0, 2, 1, 3).astype(np.float64)
    lemg4, beta4 = to4(lemg), to4(beta)
    km = (np.arange(K) < K_real).astype(np.float64)
    k_mask = np.arange(K) < K_real
    invs = jnipt.INVS
    aS = np.zeros((B, 6, 3, K))
    lgS = np.zeros((B, 6, 3))
    chosen_g = np.zeros((G, B), np.int64)
    probs_g = np.zeros((G, B, 6))
    for g in range(G):
        lm = np.where(k_mask[None, None, :], lemg4[g], -np.inf)
        e_g = np.exp(lm - lm.max(axis=2, keepdims=True)) * km[None, None, :]
        t = trans[:, g].astype(np.float64)
        a_raw = e_g[:, invs] * (t[0] * aS + (t[1] + float(g == 0)) / K_real)
        s = np.maximum(a_raw.sum(axis=3, keepdims=True), 1e-30)
        aS = a_raw / s
        lgS = lgS + np.log(s[..., 0])
        end_b = is_end[g] != 0
        junction = np.einsum("brik,bik->bri", aS, beta4[g] * km[None, None, :])
        lw = np.log(np.maximum(junction, 1e-30)).sum(axis=2) + lgS.sum(axis=2) + ht[g]
        lw = lw - lw.max(axis=1, keepdims=True)
        w = np.exp(np.clip(lw, -100.0, None)) * perm_mask
        w = w / w.sum(axis=1, keepdims=True)
        chosen = np.minimum((np.cumsum(w, axis=-1) <= u[g][:, None]).sum(axis=-1), 5)
        aS_new = np.broadcast_to(aS[np.arange(B), chosen][:, None], aS.shape)
        aS = np.where(end_b[:, None, None, None], aS_new, aS)
        lgS = np.where(end_b[:, None, None], 0.0, lgS)
        chosen_g[g] = np.where(end_b, chosen, 0)
        probs_g[g] = np.where(end_b[:, None], w, 0.0)
    return chosen_g, probs_g


def _bank_inputs(seed, G=24, B=4, K=28, K_real=25, p_end=0.3):
    rng = np.random.default_rng(seed)
    lemg, beta = random_sweep_state(rng, G, B, 4, K, K_real, 4, nl=3)[:2]
    trans = np.stack([rng.uniform(0.9, 0.999, G), rng.uniform(0.001, 0.1, G)]).astype(np.float32)
    trans[:, 0] = (1.0, 0.0)
    is_end = (rng.random((G, B)) < p_end).astype(np.int32)
    is_end[G - 1] = 1
    ht = rng.normal(0, 2, (G, B, 6)).astype(np.float32)
    u = rng.random((G, B)).astype(np.float32)
    return lemg, beta, trans, ht, u, is_end


@pytest.mark.parametrize("seed, mask", [
    (1, (1, 1, 1, 1, 1, 1)), (2, (1, 1, 1, 1, 1, 1)),
    (3, (1, 0, 1, 0, 0, 0)),                          # ff = 0: the fetal row stays
    (4, (1, 1, 1, 0, 1, 1)),
])
def test_bank_scan_plain_matches_jax_scan_step(seed, mask):
    lemg, beta, trans, ht, u, is_end = _bank_inputs(seed)
    perm_mask = np.asarray(mask, np.float32)
    K_real = 25
    ref_c, ref_p = _scan_step_f64(lemg, beta, trans, ht, u, is_end, perm_mask, K_real)
    t = torch.from_numpy
    got_c, got_p = nb.bank_scan(t(lemg), t(beta), t(trans), t(ht), t(u), t(is_end),
                                t(perm_mask), K_real)
    np.testing.assert_array_equal(got_c.numpy(), ref_c)
    np.testing.assert_allclose(got_p.numpy(), ref_p, rtol=0, atol=1e-5)
    drawn = ref_c[is_end != 0]
    assert len(np.unique(drawn)) >= 2, drawn
    assert not np.isin(drawn, np.flatnonzero(perm_mask == 0)).any()


@pytest.mark.parametrize("seed", [5, 6])
def test_bank_scan_ignores_a_row_shift(seed):
    """The kernel may exponentiate lemg against any per-(grid, row) shift:
    it scales a bank row's sums by one constant, which the normalised bank,
    the junctions and the softmax cancel."""
    lemg, beta, trans, ht, u, is_end = _bank_inputs(seed)
    rng = np.random.default_rng(seed)
    shift = rng.uniform(-20.0, 20.0, lemg.shape[:2] + (1,)).astype(np.float32)
    t = torch.from_numpy
    rest = (t(trans), t(ht), t(u), t(is_end), torch.ones(6), 25)
    c0, p0 = nb.bank_scan_plain(t(lemg), t(beta), *rest)
    c1, p1 = nb.bank_scan_plain(t(lemg + shift), t(beta), *rest)
    assert torch.equal(c0, c1)
    torch.testing.assert_close(p1, p0, rtol=0, atol=1e-5)


def test_bank_forms():
    """The kernel's form by K: 2, 5 or 8 columns a thread of 128 in
    registers, the general form (0) above 1,024."""
    assert nb._bank_cpt(40) == 2 and nb._bank_cpt(256) == 2
    assert nb._bank_cpt(640) == 5 and nb._bank_cpt(641) == 8 and nb._bank_cpt(1024) == 8
    assert nb._bank_cpt(1025) == 0 and nb._bank_cpt(3000) == 0


@pytest.mark.parametrize("G,K,form", [
    (512, 640, 5),          # the nipt path's shape: 5 columns a thread
    (512, 3000, GENERAL),   # the general form (bank in shared memory)
    (512, 6257, GENERAL),   # its last K at 512 grids
    (512, 6272, CLUSTER),   # 9K + 3G floats outgrow shared memory: the cluster form
    (32, 8192, CLUSTER),    # the wide NIPT path's shape
    (512, 12288, CLUSTER),
    (512, 16384, CLUSTER),  # the cluster form's last K: 16 blocks x 1,024 columns
    (512, 16512, GLOBAL),   # the global form past it
    (18600, 8192, CLUSTER), # the staged scalars still fit beside the cluster's exchange
    (19300, 8192, GLOBAL),  # and no longer
    (19000, 640, 5),        # 3G staged scalars still fit beside the registers
    (19300, 640, GLOBAL),   # and no longer
    (20000, 640, GLOBAL),
])
def test_bank_host_form_choices(G, K, form):
    """The bank kernel's form as the wrapper names it (the forms that ran
    before where they fit, the cluster form past them up to K = 16,384
    while the staged scalars fit shared memory, the global form past that)
    and the scratch the global form takes a chain; nothing raises at any K
    or G."""
    assert nb.bank_form(K, G) == form
    staged = (3 * G + 3) // 4 * 4
    assert nb.bank_scratch_floats(K, G) == (staged + 9 * K if form == GLOBAL else 0)


def _nipt_reads(rng, haps, pos, grid, n, coverage, ffs):
    reads, truths = [], []
    for i in range(n):
        truth = simulate_truth_mosaic(rng, haps, n_latent=3)
        r, _ = simulate_sample_reads(rng, truth, pos, grid, coverage=coverage,
                                     read_length_bp=600, phred=25, ff=float(ffs[i]))
        reads.append(r)
        truths.append(truth)
    return reads, truths


@pytest.mark.parametrize("entire", [False, True])
def test_nipt_gibbs_call_matches_jax(entire, monkeypatch):
    rng = np.random.default_rng(17 + entire)
    K, nSNPs, B = 24, 320, 2
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs, region_span=200_000)
    grid, L_grid, nGrids = assign_positions_to_grid(pos)
    reads, _ = _nipt_reads(rng, haps, pos, grid, 1, 3.0, [FF])
    reads = [reads[0].sorted_by_grid()] * B
    trans = trans_rates(np.full(nGrids - 1, 0.985))
    words = pack_bits_32(haps).view(np.int32)
    bits = np.broadcast_to(words[None], (B,) + words.shape).copy()
    gin = jg.GibbsInputs.build_batched(reads, trans, nGrids)
    n_its, NBu, R = 6, 4, gin.R
    uniforms = rng.random((n_its, B, R)).astype(np.float32)
    H0 = rng.choice(3, size=(B, R), p=jnipt.nipt_prior(FF)).astype(np.int32)
    first = rng.integers(0, reads[0].nReads, B).astype(np.int32)
    block_u = rng.random((n_its, NBu, 3, B)).astype(np.float32)
    resample_u = rng.random((n_its, B, R)).astype(np.float32)
    relabel_u = rng.random((n_its, B)).astype(np.float32) if entire else None
    do_block = np.zeros(n_its, bool)
    do_block[[2, 4]] = True
    band, idx0 = smoothing_band(L_grid, 5000)

    monkeypatch.setenv("QUILT_TPU_GIBBS", "pallas")
    ref = jg.run_gibbs_chains(
        bits=bits, preads=JaxPaddedReads.build_batched(reads, ref_error=0.001), inputs=gin,
        uniforms=uniforms, H0=H0, first_read=first, n_latent=3, ff=FF, n_burn_in=n_its - 1,
        iterative_init=True, K_real=K, block_u=block_u, do_block=do_block,
        resample_u=resample_u, relabel_u=relabel_u, do_entire=entire,
        smooth_w=(band, idx0), quantile_prob=0.9)

    port_in = GibbsInputs.build_batched(reads, trans, nGrids)
    pr = PaddedReads.build_batched(reads, ref_error=0.001)
    w_t = torch.from_numpy(bits)
    em = emat_read_from_bits(w_t, torch.from_numpy(pr.u_pad), torch.from_numpy(pr.lr),
                             torch.from_numpy(pr.la), 1e10, R_out=port_in.R)
    got = tg.run_gibbs_chains(
        tg.SlotLayout.build(port_in, B, "cpu"), torch.from_numpy(port_in.trans.T.copy()),
        torch.log(em), (em.amax(1) - em.amin(1)) <= 1e-9, torch.from_numpy(uniforms),
        torch.from_numpy(H0), torch.from_numpy(first), True, K,
        block_u=torch.from_numpy(block_u), do_block=do_block,
        smooth_w=(torch.from_numpy(band), torch.from_numpy(idx0.astype(np.int64))),
        quantile_prob=0.9, words=w_t, ref_error=0.001, nl=3, ff=FF,
        resample_u=torch.from_numpy(resample_u),
        relabel_u=None if relabel_u is None else torch.from_numpy(relabel_u))
    nr = reads[0].nReads
    assert not got.underflow.any() and not ref[5].any()
    assert (got.H.numpy()[:, :nr] == ref[3][:, :nr]).mean() > 0.995
    assert (got.H.numpy() == 2).any()
    assert got.hap_dos.shape == (B, 3, nGrids * 32)
    dos = lambda gp: gp[:, 1, :nSNPs] + 2 * gp[:, 2, :nSNPs]
    np.testing.assert_allclose(dos(got.gp.numpy()), dos(ref[0]), atol=5e-3)
    np.testing.assert_allclose(dos(got.gpF.numpy()), dos(ref[1]), atol=5e-3)
    np.testing.assert_allclose(got.per_it.numpy(), ref[4], rtol=1e-4, atol=1e-3)
    assert (got.H_class.numpy()[:, :nr] == ref[6][:, :nr]).mean() > 0.98
    assert (got.per_it.numpy()[:, :, 2] != 0).all()          # p_O3 is filled
    if entire:
        assert (got.per_it.numpy()[:, :, 7] > 1).any()       # some row was relabelled


@pytest.fixture(scope="module")
def nipt_world():
    """The world of tests/test_engine_batched.py::test_batched_nipt_groups_by_ff:
    two samples share ff = 0.2, one has 0.3 -> batches {0, 1}, {2}."""
    rng = np.random.default_rng(2)
    K, nSNPs = 100, 512
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs, region_span=60_000)
    kw = dict(chrom="chr21", pos=pos, ref_allele=np.array(["C"] * nSNPs),
              alt_allele=np.array(["T"] * nSNPs), haps=haps, nMaxDH=64)
    prep_j = prepare_panel(**kw)
    ffs = np.array([0.2, 0.2, 0.3])
    samples, truths = _nipt_reads(rng, haps, pos, prep_j.grid, 3, 4.0, ffs)
    return prep_j, prepare_panel_t(**kw), samples, truths, ffs


_ENGINE = dict(method="nipt", sample_batch=4, nGibbsSamples=3, n_seek_its=2, Ksubset=48,
               Knew=48, small_ref_panel_gibbs_iterations=8, seed=4, verbose=False)


def _r2_nipt(out, truths):
    r2m = [r2_simple((t[0] + t[1]).astype(float), r.mat_dosage)
           for t, r in zip(truths, out.results)]
    r2f = [r2_simple((t[0] + t[2]).astype(float), r.fet_dosage)
           for t, r in zip(truths, out.results)]
    return np.array(r2m), np.array(r2f)


def test_nipt_engine_matches_jax(nipt_world, tmp_path):
    prep_j, prep_t, samples, truths, ffs = nipt_world
    names = [f"S{i}" for i in range(3)]
    path = str(tmp_path / "nipt.vcf.gz")
    out_t = quilt_impute(prep_t, samples, names, ImputeConfig(**_ENGINE), "cpu",
                         output_filename=path, ff_values=ffs)
    out_j = jax_impute(prep_j, samples, names, JaxConfig(**_ENGINE), ff_values=ffs)
    (m_t, f_t), (m_j, f_j) = _r2_nipt(out_t, truths), _r2_nipt(out_j, truths)
    assert (m_t > 0.85).all() and (m_j > 0.85).all(), (m_t, m_j)
    assert (f_t > 0.5).all() and (f_j > 0.5).all(), (f_t, f_j)
    assert np.abs(m_t - m_j).max() < 0.1 and np.abs(f_t - f_j).max() < 0.2, (m_t, m_j, f_t, f_j)
    for res in out_t.results:
        assert res.phased_haps.shape == (3, 512) and set(np.unique(res.phased_haps)) <= {0, 1}
        np.testing.assert_allclose(res.mat_gp.sum(0), 1.0, atol=1e-4)
        np.testing.assert_allclose(res.fet_gp.sum(0), 1.0, atol=1e-4)
        assert (res.read_labels == 2).any()
    body = [l for l in bgzf_open(path) if not l.startswith("#")]
    fields = body[0].rstrip("\n").split("\t")
    assert len(body) == 512 and fields[8] == "GT:MGP:MDS:FGP:FDS"
    assert fields[9].split(":")[0].count("|") == 2


def test_nipt_needs_one_ff_per_sample(nipt_world):
    _, prep_t, samples, _, ffs = nipt_world
    with pytest.raises(ValueError, match="fetal fractions"):
        quilt_impute(prep_t, samples, ["a", "b", "c"], ImputeConfig(**_ENGINE), "cpu",
                     ff_values=ffs[:2])


def test_quilt2_nipt_engine(tmp_path):
    """QUILT2-NIPT: msPBWT selection (the dosages come from the Gibbs dosage
    pass at nl = 3) and the rare/common all-SNP call."""
    rng = np.random.default_rng(8)
    K, nSNPs = 100, 512
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs, region_span=60_000)
    for s in rng.choice(nSNPs, 30, replace=False):
        haps[:, s] = 0
        haps[rng.integers(0, K), s] = 1
    prep = prepare_panel_t(chrom="chr21", pos=pos, ref_allele=np.array(["C"] * nSNPs),
                           alt_allele=np.array(["T"] * nSNPs), haps=haps, nMaxDH=64,
                           impute_rare_common=True, rare_af_threshold=0.03, use_mspbwt=True,
                           mspbwt_nindices=2)
    samples, truths = _nipt_reads(rng, haps, pos, prep.grid_all, 2, 4.0, [0.2, 0.2])
    cfg = ImputeConfig(use_mspbwt=True, impute_rare_common=True, **_ENGINE)
    path = str(tmp_path / "q2nipt.vcf.gz")
    out = quilt_impute(prep, samples, ["S0", "S1"], cfg, "cpu", output_filename=path,
                       ff_values=np.array([0.2, 0.2]))
    r2m, r2f = _r2_nipt(out, truths)
    assert (r2m > 0.85).all() and (r2f > 0.5).all(), (r2m, r2f)
    for res in out.results:
        assert res.mat_dosage.shape == (nSNPs,) and res.phased_haps.shape == (3, nSNPs)
    body = [l for l in bgzf_open(path) if not l.startswith("#")]
    assert len(body) == nSNPs and body[0].split("\t")[8] == "GT:MGP:MDS:FGP:FDS"


def test_cli_nipt_on_cpu(tmp_path):
    vcf, gmap, bamlist, truths, nSNPs = write_bam_world(
        str(tmp_path), np.random.default_rng(5), nSNPs=256, n_samples=1, ff=0.25, coverage=3.0)
    outdir = str(tmp_path / "out")
    assert cli.main(["prepare", "--outputdir", outdir, "--chr", "chr20",
                     "--reference_vcf_file", vcf, "--genetic_map_file", gmap,
                     "--nGen", "100"]) == 0
    imp = ["impute", "--outputdir", outdir, "--chr", "chr20", "--bamlist", bamlist,
           "--method", "nipt", "--nGibbsSamples", "2", "--n_seek_its", "2", "--Ksubset", "48",
           "--Knew", "48", "--small_ref_panel_gibbs_iterations", "8", "--verbose", "FALSE"]
    assert cli.main(imp, device="cpu") == 1                  # no --fflist
    fflist = tmp_path / "ff.txt"
    fflist.write_text("0.25\n")
    assert cli.main(imp + ["--fflist", str(fflist)], device="cpu") == 0
    body = [l for l in bgzf_open(f"{outdir}/quilt.chr20.vcf.gz") if not l.startswith("#")]
    assert len(body) == nSNPs and body[0].split("\t")[8] == "GT:MGP:MDS:FGP:FDS"
    mds = np.array([float(l.split("\t")[9].split(":")[2]) for l in body])
    fds = np.array([float(l.split("\t")[9].split(":")[4]) for l in body])
    assert np.isfinite(fds).all() and 0 <= fds.min() and fds.max() <= 2
    r2 = np.corrcoef(mds, truths[0][:2].sum(axis=0))[0, 1] ** 2
    assert r2 > 0.8, f"maternal r2 {r2}"
