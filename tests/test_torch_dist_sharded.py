"""The panel-sharded FB of the port (quilt_tpu_torch.dist.mesh.ShardedFB over
kernels/fb_sharded.py) on the CPU: the plain segment passes and steps
against a float64 NumPy transcription of the JAX body's segment step
(quilt_tpu/kernels/fb_full.py:_fb_core_segmented), the whole sharded FB
against the port's fused FB (fb_core) and against the JAX package's
fb_full_sharded on a 2 x 4 mesh, and the three cases of
tests/test_dist_sharded.py.

Tolerances. Segment passes against float64: rtol 2e-5 (float32 products of
at most 8 factors and sums over a few hundred haplotypes). Sharded against
the port's fused FB (both float32, other orders of summation; measured
within 1e-6 / 3.1e-5): dosage atol 1e-5, log-likelihood atol 1e-3 (of
~300), top-K values and the captured gamma atol 1e-5, the top-K haplotypes
equal wherever neighbouring values differ by more than 1e-3. Against the
JAX package (whose XLA body takes its emissions through a bf16 one-hot
product): the JAX test's dosage atol 3e-3, log-likelihood rtol 1e-3 / atol
0.5, top-K values atol 2e-3 (tests/test_dist_sharded.py:39-40,74-77,96);
its top-K overlap >= 7 of 8 holds port against port (the three ported
cases), and across the packages every haplotype whose value stands above
the list's 8th by more than 2e-3 is in both lists (the rest are ties that
the bf16 emissions reorder)."""
import numpy as np
import pytest
import torch

from quilt_tpu.dist import fb_full_sharded as jax_fb_full_sharded
from quilt_tpu.dist import make_mesh as jax_make_mesh
from quilt_tpu.io import simulate_panel, simulate_sample_reads
from quilt_tpu.io.simulate import simulate_truth_mosaic
from quilt_tpu.kernels import FBInputs as JaxFBInputs
from quilt_tpu.oracle import make_gl_from_reads
from quilt_tpu.panel import assign_positions_to_grid, compress_panel, trans_rates
from quilt_tpu.utils import pack_bits_32

from quilt_tpu_torch.dist import fb_full_sharded, make_mesh
from quilt_tpu_torch.inputs import FB_FIELDS, fb_inputs_from_reference
from quilt_tpu_torch.kernels import fb_sharded as fs
from quilt_tpu_torch.kernels.fb import fb_full_batched

torch.set_num_threads(2)

L = fs.SEG_LEN
TRI = [(l, i) for l in range(L) for i in range(l, L)]


def _world(rng, K=96, nSNPs=320, nMaxDH=96):
    """tests/test_dist_sharded.py's world: B = 4 rows (2 data shards)."""
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs)
    grid, _, nGrids = assign_positions_to_grid(pos)
    panel = compress_panel(pack_bits_32(haps), len(pos), nMaxDH=nMaxDH)
    trans = trans_rates(np.full(nGrids - 1, 0.99))
    truth = simulate_truth_mosaic(rng, haps, n_latent=2)
    reads, sim = simulate_sample_reads(rng, truth, pos, grid, coverage=2.0,
                                       read_length_bp=1000)
    gls = [make_gl_from_reads(reads, np.flatnonzero(sim.labels == h), len(pos))
           for h in (0, 1)]
    return panel, trans, np.stack(gls * 2).astype(np.float32), nGrids


def _port(ref):
    return fb_inputs_from_reference({k: getattr(ref, k) for k in FB_FIELDS})


# ---------------------------------------------------------------------------
# the segment passes against a float64 transcription of the JAX step
# ---------------------------------------------------------------------------

def _np_fwd_seg(e, t, a0, K):
    """fwd_seg of _fb_core_segmented on one shard in float64: (local sums,
    the segment's alphas [L, B, KS], log M_L)."""
    T = [t[i, 0] * e[i] for i in range(L)]
    R = {}
    for l in range(L):
        U = T[l]
        R[(l, l)] = U
        for i in range(l + 1, L):
            U = U * T[i]
            R[(l, i)] = U
    flat = np.stack([(R[(0, i)] * a0).sum(1) for i in range(L)]
                    + [R[p].sum(1) for p in TRI], 1)
    cl = [t[i, 1] / (K * max(t[i, 0], 1e-30)) for i in range(L)]
    M = [np.ones(a0.shape[0])]
    for i in range(L):
        M.append(flat[:, i] + sum(cl[l] * M[l] * flat[:, L + TRI.index((l, i))]
                                  for l in range(i + 1)))
    alphas = [(R[(0, i)] * a0 + sum((cl[l] * M[l])[:, None] * R[(l, i)] for l in range(i + 1)))
              / np.maximum(M[i + 1], 1e-30)[:, None] for i in range(L)]
    return flat, np.stack(alphas), np.log(np.maximum(M[L], 1e-30))


def _np_bwd_seg(e, t, eR, tR, beta_R, a, K):
    """bwd_seg of _fb_core_segmented on one shard in float64 (beta_R
    normalised): (local sums q, NR, Qr; B_j [L, B, KS])."""
    nxt_e = [e[j + 1] for j in range(L - 1)] + [eR]
    nxt_t = [t[j + 1] for j in range(L - 1)] + [tR]
    cb = [nxt_t[j][1] / K for j in range(L)]
    T = [nxt_t[j][0] * nxt_e[j] for j in range(L)]
    Rb = {}
    for j in range(L - 1, -1, -1):
        Rb[(j, j)] = T[j]
        for l in range(j + 1, L):
            Rb[(j, l)] = Rb[(j, l - 1)] * T[l]
    q = [(e[j] * Rb[(j, L - 1)] * beta_R).sum(1) for j in range(L)]
    Qr = {(j, l): (e[j] if l == j else e[j] * Rb[(j, l - 1)]).sum(1) for j, l in TRI}
    flat = np.stack(q + [(eR * beta_R).sum(1)] + [Qr[p] for p in TRI], 1)
    N = [None] * (L + 1)
    N[L] = flat[:, L]
    for j in range(L - 1, -1, -1):
        N[j] = q[j] + sum(cb[l] * N[l + 1] * Qr[(j, l)] for l in range(j, L))
    Bs = []
    for j in range(L):
        Bj = Rb[(j, L - 1)] * beta_R + (cb[j] * N[j + 1])[:, None]
        for l in range(j + 1, L):
            Bj = Bj + (cb[l] * N[l + 1])[:, None] * Rb[(j, l - 1)]
        Bs.append(Bj)
    return flat, np.stack(Bs)


@pytest.fixture(scope="module")
def seg_world():
    """One shard of 700 haplotypes (two tiles, the second ragged), 640 real,
    16 grids, 3 rows; a thinned grid in each segment, capture at grid 5."""
    rng = np.random.default_rng(11)
    Gp, KS, B, K_loc = 16, 700, 3, 640
    words = rng.integers(-2**31, 2**31, (Gp, KS), dtype=np.int64).astype(np.int32)
    gl = 0.05 + 0.95 * rng.random((B, 2, Gp * 32))
    t0 = gl[:, 0] * 0.999 + gl[:, 1] * 0.001
    t1 = gl[:, 0] * 0.001 + gl[:, 1] * 0.999
    dl = (np.log(t1) - np.log(t0)).astype(np.float32)
    trans = np.tile([0.97, 0.03], (Gp, 1)) + rng.uniform(-0.01, 0.01, (Gp, 2))
    trans[0] = (1.0, 1.0)
    trans2 = np.ascontiguousarray(trans.T).astype(np.float32)
    bits = (words.view(np.uint32)[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    logit = np.einsum("bgs,gks->gbk", dl.astype(np.float64).reshape(B, Gp, 32),
                      bits.astype(np.float64))
    logit[:, :, K_loc:] = -np.inf
    mx = logit.max(2)
    e = np.exp(logit - mx[:, :, None])                           # [Gp, B, KS] float64
    thin = np.full(Gp, -1, dtype=np.int32)
    thin[[2, 11]] = [0, 1]
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    return dict(words=T(words), dl=T(dl), trans2=T(trans2), mx=T(mx.astype(np.float32)),
                thin=T(thin), e=e, trans=trans2.T.astype(np.float64), bits=bits, K_loc=K_loc,
                Gp=Gp, KS=KS, B=B)


def test_segment_passes_match_float64_transcription(seg_world):
    """The path's passes (seg_fwd_local of segment 0, a seg_fwd_step a
    segment, seg_bwd_local of the last, a seg_bwd_step a segment) against
    the float64 transcription: each step's local sums of the next segment,
    the alphas (the forward step's and the backward's rebuilt ones), log
    M, the carry and the gamma outputs."""
    w = seg_world
    Gp, KS, B, K_loc, K = w["Gp"], w["KS"], w["B"], w["K_loc"], 640
    args = (w["dl"], w["words"], w["trans2"], w["mx"])
    NSC = Gp // L
    alphas = torch.zeros((Gp, B, KS), dtype=torch.float32)
    ckpt = torch.zeros((NSC, B, KS), dtype=torch.float32)
    scal = torch.zeros((NSC, B, fs.SCAL_VALS), dtype=torch.float32)
    logm = torch.zeros((NSC, B), dtype=torch.float32)
    rel = lambda got, ref: np.testing.assert_allclose(got, ref, rtol=2e-5,
                                                      atol=2e-5 * np.abs(ref).max())
    part = fs.seg_fwd_local(*args, None, 0, K_loc)
    for c in range(NSC):
        assert part.shape == (B, 2, fs.FWD_VALS)
        a0 = alphas[c * L - 1].double().numpy() if c else np.zeros((B, KS))
        flat, al, lm = _np_fwd_seg(w["e"][c * L:(c + 1) * L], w["trans"][c * L:(c + 1) * L],
                                   a0, K)
        rel(part.sum(1).numpy(), flat)
        part = fs.seg_fwd_step(*args, part.sum(1), ckpt, scal, logm, c, K_loc, K,
                               _alphas=alphas[c * L:(c + 1) * L])
        rel(alphas[c * L:(c + 1) * L].numpy(), al)
        assert torch.equal(ckpt[c], alphas[(c + 1) * L - 1])
        np.testing.assert_allclose(logm[c].numpy(), lm, rtol=1e-5)
    assert part is None
    np.testing.assert_allclose(alphas.sum(2).numpy(), 1.0, rtol=1e-5)

    K_top, nt = 4, 2
    out = dict(dpart=torch.zeros((nt, B, Gp * 32)), gnp=torch.zeros((nt, Gp, B)),
               tvp=torch.zeros((nt, Gp, B, K_top)),
               tip=torch.zeros((nt, Gp, B, K_top), dtype=torch.int32), gcap=torch.zeros((B, KS)))
    beta = torch.ones((B, KS), dtype=torch.float32)
    part = fs.seg_bwd_local(*args, beta, NSC - 1, K_loc)
    for c in (1, 0):
        beta_R = beta.double().numpy()     # ones, then the carry B_0 / N_0
        g0 = c * L
        eR = np.ones((B, KS)) if c == 1 else w["e"][g0 + L]
        tR = np.array([1.0, 0.0]) if c == 1 else w["trans"][g0 + L]
        flat, Bs = _np_bwd_seg(w["e"][g0:g0 + L], w["trans"][g0:g0 + L], eR, tR, beta_R,
                               alphas[g0:g0 + L].double().numpy(), K)
        tot = part.sum(1)
        rel(tot.numpy(), flat)
        rebuilt = torch.zeros((L, B, KS), dtype=torch.float32)
        part = fs.seg_bwd_step(*args, ckpt, scal, tot, w["thin"], beta, out, c, K_loc, K, 100, 5,
                               _alphas=rebuilt)
        assert (part is None) == (c == 0)
        assert torch.equal(rebuilt, alphas[g0:g0 + L])
        # the carry: B_0 over its emission-weighted mass N_0
        rel(beta.numpy(), Bs[0] / (w["e"][g0] * Bs[0]).sum(1, keepdims=True))
        np.testing.assert_allclose((w["e"][g0] * beta.double().numpy()).sum(1), 1.0, rtol=1e-5)
        # the step scales grid j's numerators by M_{j+1} / M_L
        gs = torch.stack(fs.gamma_scale_plain(scal, c)).double().numpy()   # [L, B]
        gam = alphas[g0:g0 + L].double().numpy() * Bs * gs[:, :, None]    # [L, B, KS]
        rel(out["gnp"].sum(0)[g0:g0 + L].numpy(), gam.sum(2))
        dos = np.einsum("jbk,jks->bjs", gam, w["bits"][g0:g0 + L].astype(np.float64))
        rel(out["dpart"].sum(0)[:, g0 * 32:(g0 + L) * 32].numpy(), dos.reshape(B, L * 32))
        for g in range(g0, g0 + L):
            tv, ti = out["tvp"][:, g], out["tip"][:, g]                     # [nt, B, K_top]
            if w["thin"][g] < 0:
                assert not tv.any() and not ti.any()
                continue
            for b in range(B):
                real = gam[g - g0, b, :K_loc]
                for t in range(nt):
                    tile = real[t * 512:(t + 1) * 512]
                    top = np.argsort(-tile, kind="stable")[:K_top]
                    np.testing.assert_allclose(tv[t, b].numpy(), tile[top], rtol=2e-5)
                    assert (ti[t, b].numpy() == 100 + t * 512 + top).all()
        if c == 0:
            rel(out["gcap"].numpy(), gam[5])


# ---------------------------------------------------------------------------
# the whole sharded FB
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wide_world():
    """K = 300 over 448 SNPs, nMaxDH 16 (escapes), every third grid thinned,
    capture at the middle grid; 5 rows (on 2 data rows, padded to 6)."""
    rng = np.random.default_rng(5)
    panel, trans, gl, nGrids = _world(rng, K=300, nSNPs=448, nMaxDH=16)
    assert len(panel.esc_k) > 0
    ref = JaxFBInputs.build(panel, trans, thinned_grids=np.arange(0, nGrids, 3))
    ref.capture_grid = nGrids // 2
    gl = np.concatenate([gl, gl[:1]])
    return _port(ref), ref, gl


def _firm_topk_equal(tv, ti, tv_ref, ti_ref, grids):
    firm = (tv_ref[grids, :, :-1] - tv_ref[grids, :, 1:]) > 1e-3
    assert firm.any()
    np.testing.assert_array_equal(ti[grids, :, :-1][firm], ti_ref[grids, :, :-1][firm])


@pytest.mark.parametrize("n_panel", [1, 2, 4])
def test_sharded_fb_matches_fused_fb(wide_world, n_panel):
    fb, _, gl = wide_world
    B, K_top = gl.shape[0], 8
    d_ref, l_ref, tv_ref, ti_ref, g_ref = (x.numpy() for x in fb_full_batched(
        torch.from_numpy(gl), fb, K_top=K_top, family="fused"))
    d, ll, tv, ti, gcap = (x.numpy() for x in fb_full_sharded(
        torch.from_numpy(gl), fb, make_mesh(1, n_panel, ["cpu"] * n_panel), K_top=K_top))
    assert d.shape == (B, fb.nSNPs) and tv.shape == (fb.nGrids, B, K_top * n_panel)
    np.testing.assert_allclose(d, d_ref[:, :fb.nSNPs], atol=1e-5)
    np.testing.assert_allclose(ll, l_ref, atol=1e-3)
    thin = np.flatnonzero(fb.thin_flag >= 0)
    np.testing.assert_allclose(tv[thin, :, :K_top], tv_ref[thin], atol=1e-5)
    _firm_topk_equal(tv[:, :, :K_top], ti[:, :, :K_top], tv_ref, ti_ref, thin)
    assert not tv[fb.thin_flag < 0].any() and not ti[fb.thin_flag < 0].any()
    assert (ti < fb.K).all() and (ti[tv == 0] == 0).all()
    np.testing.assert_allclose(gcap, g_ref, atol=1e-5)


def test_sharded_fb_matches_jax_on_2x4_mesh(wide_world):
    fb, ref, gl = wide_world
    d_j, l_j, tv_j, ti_j, g_j = jax_fb_full_sharded(gl, ref, jax_make_mesh(2, 4), K_top=8)
    mesh = make_mesh(2, 4, ["cpu"] * 8)
    d, ll, tv, ti, gcap = (x.numpy() for x in fb_full_sharded(torch.from_numpy(gl), fb, mesh,
                                                              K_top=8))
    assert tv.shape == tv_j.shape == (fb.nGrids, gl.shape[0], 32)
    np.testing.assert_allclose(d, d_j, atol=3e-3)
    np.testing.assert_allclose(ll, l_j, rtol=1e-3, atol=0.5)
    np.testing.assert_allclose(gcap, g_j, atol=3e-3)
    for g in np.flatnonzero(fb.thin_flag >= 0):
        for b in range(gl.shape[0]):
            # a haplotype whose gamma is more than the values' tolerance above
            # the JAX list's 8th is in the port's top 8 (the rest are ties:
            # the bf16 emissions reorder them, and JAX's own sharded and
            # single-device lists share only 6 of 8 at some grids here)
            firm = ti_j[g, b, :8][tv_j[g, b, :8] > tv_j[g, b, 7] + 2e-3]
            assert set(firm.tolist()) <= set(ti[g, b, :8].tolist()), (g, b)
            np.testing.assert_allclose(tv[g, b, :8], tv_j[g, b, :8], atol=2e-3)


# the three cases of tests/test_dist_sharded.py, on the port's 2 x 4 mesh of
# CPU devices against the port's single-device FB

def test_fb_sharded_matches_replicated():
    panel, trans, gl_b, _ = _world(np.random.default_rng(7), nMaxDH=96)
    assert len(panel.esc_k) == 0
    fb = _port(JaxFBInputs.build(panel, trans))
    dosage_ref, ll_ref, _, _ = fb_full_batched(torch.from_numpy(gl_b), fb, K_top=8)
    dosage_sh, ll_sh, tv, _ = fb_full_sharded(gl_b, fb, make_mesh(2, 4, ["cpu"] * 8), K_top=4)
    np.testing.assert_allclose(dosage_sh, dosage_ref[:, :fb.nSNPs], atol=3e-3)
    np.testing.assert_allclose(ll_sh, ll_ref, rtol=1e-3, atol=0.5)
    assert tv.shape[2] == 16  # 4 shards x K_top 4


def test_fb_sharded_exact_with_escapes_and_thinning():
    panel, trans, gl_b, nGrids = _world(np.random.default_rng(7), nMaxDH=8)
    assert len(panel.esc_k) > 0
    thinned = np.arange(0, nGrids, 3)
    fb = _port(JaxFBInputs.build(panel, trans, thinned_grids=thinned))
    dosage_ref, ll_ref, tv_ref, ti_ref = (x.numpy() for x in fb_full_batched(
        torch.from_numpy(gl_b), fb, K_top=8))
    dosage_sh, ll_sh, tv_sh, ti_sh = (x.numpy() for x in fb_full_sharded(
        gl_b, fb, make_mesh(2, 4, ["cpu"] * 8), K_top=8))
    np.testing.assert_allclose(dosage_sh, dosage_ref[:, :fb.nSNPs], atol=3e-3)
    np.testing.assert_allclose(ll_sh, ll_ref, rtol=1e-3, atol=0.5)
    thin_mask = np.zeros(fb.nGrids, dtype=bool)
    thin_mask[thinned] = True
    assert (tv_sh[~thin_mask] == 0).all()
    for g in thinned[:5]:
        for b in range(gl_b.shape[0]):
            overlap = len(set(ti_ref[g, b].tolist()) & set(ti_sh[g, b, :8].tolist()))
            assert overlap >= 7, (g, b)
            np.testing.assert_allclose(tv_sh[g, b, :8], tv_ref[g, b], atol=2e-3)


def test_fb_sharded_gamma_capture():
    panel, trans, gl_b, nGrids = _world(np.random.default_rng(7), nMaxDH=96)
    ref = JaxFBInputs.build(panel, trans)
    ref.capture_grid = nGrids // 2
    fb = _port(ref)
    out_ref = fb_full_batched(torch.from_numpy(gl_b), fb, K_top=8)
    assert len(out_ref) == 5
    out_sh = fb_full_sharded(gl_b, fb, make_mesh(2, 4, ["cpu"] * 8), K_top=8)
    assert len(out_sh) == 5
    gcap_sh = out_sh[4].numpy()
    assert gcap_sh.shape == tuple(out_ref[4].shape)
    np.testing.assert_allclose(gcap_sh, out_ref[4].numpy(), atol=3e-3)
    np.testing.assert_allclose(gcap_sh.sum(axis=1), 1.0, atol=1e-3)


def test_two_runs_give_the_same_bits(wide_world):
    fb, _, gl = wide_world
    mesh = make_mesh(1, 2, ["cpu"] * 2)
    a = fb_full_sharded(torch.from_numpy(gl), fb, mesh, K_top=8)
    b = fb_full_sharded(torch.from_numpy(gl), fb, mesh, K_top=8)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
