"""The panel-sharded FB's fused segment steps (kernels/fb_sharded.py
seg_fwd_step / seg_bwd_step, csrc/fb_sharded.cu) on the CPU, where the
wrappers run their plain versions: each step equals the pair of passes it
replaces (the previous form's apply pass, then the next segment's local
pass) bit for bit, but for the backward's scale of each grid's gamma
numerators; the backward's alphas, rebuilt from the checkpoint plane and
the scalar plane, equal the forward's bit for bit at every segment; the
step body of sharded_core agrees with its previous four-pass body
(_prev=True); the gamma normaliser stays in float32's range where the
previous form's left it (K = 16,384, every SNP informative); the body
allocates a [Gp/L, B, K_shard] checkpoint plane and no [Gp, B, K_shard]
plane; a call launches 2 (Gp/L + 1) segment kernels a shard. The worlds have a ragged last tile, padded
haplotypes, a capture grid and pairs of equal panel columns, whose gammas
tie at the thinned grids (top-K takes the lower index first).

The comparisons are exact where the same float32 operations run in the
same order (the plain steps are built from the plain passes and one alpha
helper); sums of 512 terms taken after the gamma scaling are held within
4e-6 (float32 rounding of the sums), whole calls within 1e-5. The sharded
FB against the fused FB and the JAX package stays in
tests/test_torch_dist_sharded.py at its tolerances."""
import numpy as np
import pytest
import torch

from quilt_tpu_torch.dist import make_mesh
from quilt_tpu_torch.dist.mesh import ShardedFB
from quilt_tpu_torch.inputs import FBInputs
from quilt_tpu_torch.kernels import fb_sharded as fs

torch.set_num_threads(2)

L = fs.SEG_LEN


def _shard_world(seed=3, Gp=32, KS=700, K_loc=640, B=3):
    """One shard: Gp grids (Gp / 8 segments), K_shard columns of which the
    first K_loc are real (a ragged second tile), columns 2m and 2m + 1
    equal, a thinned grid in every segment, the capture at grid 13."""
    rng = np.random.default_rng(seed)
    words = rng.integers(-2**31, 2**31, (Gp, KS), dtype=np.int64).astype(np.int32)
    words[:, 1::2] = words[:, 0::2][:, :KS // 2]
    gl = 0.05 + 0.95 * rng.random((B, 2, Gp * 32))
    dl = np.log((gl[:, 0] * 0.001 + gl[:, 1] * 0.999) / (gl[:, 0] * 0.999 + gl[:, 1] * 0.001))
    trans = np.tile([0.97, 0.03], (Gp, 1)) + rng.uniform(-0.01, 0.01, (Gp, 2))
    trans[0] = (1.0, 1.0)
    thin = np.where(np.arange(Gp) % L == 3, np.arange(Gp) // L, -1).astype(np.int32)
    T = lambda x, dt: torch.from_numpy(np.ascontiguousarray(x).astype(dt))
    dl_t = T(dl, np.float32)
    words_t = T(words, np.int32)
    from quilt_tpu_torch.kernels.fb import fb_max_tiled_plain
    mx = fb_max_tiled_plain(dl_t, words_t, K_loc, KS)
    return dict(dl=dl_t, words=words_t, trans2=T(trans.T, np.float32), mx=mx,
                thin=T(thin, np.int32), Gp=Gp, KS=KS, K_loc=K_loc, B=B, K=K_loc + 60, k0=100,
                cap=13)


def _outs(w, K_top=4):
    nt, B, Gp, KS = fs.n_tiles(w["KS"]), w["B"], w["Gp"], w["KS"]
    return dict(dpart=torch.zeros((nt, B, Gp * 32)), gnp=torch.zeros((nt, Gp, B)),
                tvp=torch.zeros((nt, Gp, B, K_top)),
                tip=torch.zeros((nt, Gp, B, K_top), dtype=torch.int32),
                gcap=torch.zeros((B, KS)))


def _run_steps(w):
    """The step body on one shard (its own sums standing in for the
    group's): (forward parts, forward alphas, logm, ckpt, scal; backward
    parts, rebuilt alphas, beta after each step, outs)."""
    args = (w["dl"], w["words"], w["trans2"], w["mx"])
    NSC, B, KS = w["Gp"] // L, w["B"], w["KS"]
    ckpt, scal = torch.zeros((NSC, B, KS)), torch.zeros((NSC, B, fs.SCAL_VALS))
    logm = torch.zeros((NSC, B))
    fparts, falphas = [fs.seg_fwd_local(*args, None, 0, w["K_loc"])], []
    for c in range(NSC):
        a = torch.zeros((L, B, KS))
        fparts.append(fs.seg_fwd_step(*args, fparts[-1].sum(1) + 1e-3, ckpt, scal, logm, c,
                                      w["K_loc"], w["K"], _alphas=a))
        falphas.append(a)
    out = _outs(w)
    beta = torch.ones((B, KS))
    bparts, balphas, betas = [fs.seg_bwd_local(*args, beta, NSC - 1, w["K_loc"])], {}, {}
    for c in range(NSC - 1, -1, -1):
        a = torch.zeros((L, B, KS))
        bparts.append(fs.seg_bwd_step(*args, ckpt, scal, bparts[-1].sum(1) + 1e-3, w["thin"],
                                      beta, out, c, w["K_loc"], w["K"], w["k0"], w["cap"],
                                      _alphas=a))
        balphas[c], betas[c] = a, beta.clone()
    return fparts, falphas, logm, ckpt, scal, bparts, balphas, betas, out


def _run_pairs(w):
    """The previous form's passes on the same inputs: a local and an apply
    pass a segment in each direction, every alpha in a [Gp, B, K_shard]
    plane."""
    args = (w["dl"], w["words"], w["trans2"], w["mx"])
    NSC, B, KS, Gp = w["Gp"] // L, w["B"], w["KS"], w["Gp"]
    alphas, logm = torch.zeros((Gp, B, KS)), torch.zeros((NSC, B))
    fparts = []
    for c in range(NSC):
        a0 = alphas[c * L - 1] if c else None
        fparts.append(fs.seg_fwd_local_plain(*args, a0, c, w["K_loc"]))
        fs.seg_fwd_apply(*args, fparts[-1].sum(1) + 1e-3, a0, alphas[c * L:(c + 1) * L], logm, c,
                         w["K_loc"], w["K"])
    out = _outs(w)
    beta = torch.ones((B, KS))
    bparts, betas = [], {}
    for c in range(NSC - 1, -1, -1):
        bparts.append(fs.seg_bwd_local(*args, beta, c, w["K_loc"]))
        fs.seg_bwd_apply(*args, alphas[c * L:(c + 1) * L], bparts[-1].sum(1) + 1e-3, w["thin"],
                         beta, out, c, w["K_loc"], w["K"], w["k0"], w["cap"])
        betas[c] = beta.clone()
    return fparts, alphas, logm, bparts, betas, out


@pytest.fixture(scope="module")
def shard_world():
    return _shard_world()


@pytest.fixture(scope="module")
def both(shard_world):
    return _run_steps(shard_world), _run_pairs(shard_world)


def test_plain_steps_equal_the_pass_pairs(shard_world, both):
    """seg_fwd_step(c) = seg_fwd_apply(c) then seg_fwd_local(c + 1), and
    seg_bwd_step(c) = seg_bwd_apply(c) then seg_bwd_local(c - 1), bit for
    bit: the local sums each step returns, the alphas, log M, the carry and
    the top-K haplotypes (tied ones included); the backward step's gamma
    numerators are the pair's times the grid's scale M_{j+1} / M_L
    (gamma_scale_plain): the top-K values and the capture bit for bit, the
    per-tile sums within 4e-6 (summed after the scaling)."""
    w = shard_world
    (fparts, falphas, logm, ckpt, scal, bparts, _, betas, out), \
        (fparts_p, alphas_p, logm_p, bparts_p, betas_p, out_p) = both
    NSC = w["Gp"] // L
    assert fparts[-1] is None and bparts[-1] is None
    for c in range(NSC):
        assert torch.equal(fparts[c], fparts_p[c])
        assert torch.equal(falphas[c], alphas_p[c * L:(c + 1) * L])
        assert torch.equal(ckpt[c], alphas_p[(c + 1) * L - 1])
        assert torch.equal(bparts[c], bparts_p[c])
        assert torch.equal(betas[c], betas_p[c])
    assert torch.equal(logm, logm_p)
    gs = torch.stack([torch.stack(fs.gamma_scale_plain(scal, c)) for c in range(NSC)])
    gs = gs.reshape(NSC * L, w["B"])                                  # [Gp, B]
    assert torch.equal(out["tvp"], out_p["tvp"] * gs[None, :, :, None])
    assert torch.equal(out["tip"], out_p["tip"])
    assert torch.equal(out["gcap"], out_p["gcap"] * gs[w["cap"]][:, None])
    torch.testing.assert_close(out["gnp"], out_p["gnp"] * gs[None], rtol=4e-6, atol=0)
    dscale = gs.T.repeat_interleave(32, dim=1)[None]                  # [1, B, Gp*32]
    torch.testing.assert_close(out["dpart"], out_p["dpart"] * dscale, rtol=4e-6, atol=1e-30)
    assert out["gcap"].abs().sum() > 0


def test_rebuilt_alphas_equal_the_forwards_at_every_segment(shard_world, both):
    """The backward step's alphas, rebuilt from checkpoint c - 1 and scal[c]
    (the initial alpha, zero, at c = 0), are the forward step's bit for
    bit, and so is rebuilt_alphas_plain."""
    w = shard_world
    (_, falphas, _, ckpt, scal, _, balphas, _, _), _ = both
    args = (w["dl"], w["words"], w["trans2"], w["mx"])
    for c in range(w["Gp"] // L):
        assert torch.equal(balphas[c], falphas[c]), c
        assert torch.equal(torch.stack(fs.rebuilt_alphas_plain(*args, ckpt, scal, c, w["K_loc"])),
                           falphas[c])
        assert falphas[c][:, :, :w["K_loc"]].gt(0).all()
        assert not falphas[c][:, :, w["K_loc"]:].any()


def test_tied_gammas_keep_the_lower_index_first(shard_world, both):
    """Columns 2m and 2m + 1 are equal, so their gammas tie exactly; each
    tile's top-K list at a thinned grid takes the lower index first."""
    w = shard_world
    (*_, out), _ = both
    thin = np.flatnonzero(w["thin"].numpy() >= 0)
    tv, ti = out["tvp"][:, thin].numpy(), out["tip"][:, thin].numpy()
    assert (tv > 0).all()
    pairs = ti[..., 0::2], ti[..., 1::2]
    tied = tv[..., 0::2] == tv[..., 1::2]
    assert tied.all()
    assert (pairs[1][tied] == pairs[0][tied] + 1).all()
    assert ((pairs[0][tied] - w["k0"]) % 2 == 0).all()


def _fb_world(seed=9, K=300, nGrids=64, capture_grid=29):
    """FB inputs of a random panel with K = 300 (K_pad 384), columns 2m and
    2m + 1 equal, every fifth grid thinned, a capture grid."""
    rng = np.random.default_rng(seed)
    K_pad = -(-K // 128) * 128
    words = np.zeros((nGrids, K_pad), dtype=np.int32)
    words[:, :K] = rng.integers(-2**31, 2**31, (nGrids, K), dtype=np.int64).astype(np.int32)
    words[:, 1:K:2] = words[:, 0:K - 1:2]
    trans = np.tile(np.float32([0.97, 0.03]), (nGrids, 1))
    trans[0] = (1.0, 1.0)
    thin = np.full(nGrids, -1, dtype=np.int32)
    thin[::5] = np.arange(len(thin[::5]))
    fb = FBInputs(words=words, trans=trans, thin_flag=thin, K=K, K_pad=K_pad, nGrids=nGrids,
                  S=nGrids * 32, nSNPs=nGrids * 32, capture_grid=capture_grid)
    gl = (0.05 + 0.95 * rng.random((5, 2, fb.S))).astype(np.float32)
    return fb, torch.from_numpy(gl)


def _core(sfb, gl, prev):
    (group, shards), = sfb.rows
    return fs.sharded_core(gl, shards, group, sfb.inputs.K, sfb.K_top, sfb.ref_error,
                           sfb.inputs.capture_grid, _prev=prev)


@pytest.mark.parametrize("n_panel", [1, 2, 4])
def test_step_body_agrees_with_the_four_pass_body(n_panel):
    """sharded_core's step body against its previous form (_prev=True) on
    one data row of 1, 2 and 4 shards (the last shard of 4 holds padding
    only past K): the log-likelihood bit for bit (the same forward), the
    dosage, top-K values and capture within 1e-5 (the steps scale each
    grid's gamma numerators before summing them: measured within 1.7e-6),
    the top-K haplotypes equal, and the same exchanges."""
    fb, gl = _fb_world()
    sfb = ShardedFB(fb, make_mesh(1, n_panel, ["cpu"] * n_panel))
    group = sfb.rows[0][0]
    new = _core(sfb, gl, False)
    e_new = group.exchanges
    old = _core(sfb, gl, True)
    assert group.exchanges - e_new == e_new == 2 * fb.nGrids // L + 2
    assert len(new) == len(old) == 5
    assert torch.equal(new[1], old[1])
    for i in (0, 2, 4):
        torch.testing.assert_close(new[i], old[i], rtol=0, atol=1e-5)
    assert torch.equal(new[3], old[3])


def _gamma_sums(monkeypatch, sfb, gl, prev):
    """(the call's outputs, the sum of its gamma numerators at each (grid,
    row) over the panel [Gp, B]), from the per-tile sums of the backward's
    wrapper (the step's, or the previous form's apply pass)."""
    name, at = ("seg_bwd_apply", 8) if prev else ("seg_bwd_step", 9)
    outs, real = {}, getattr(fs, name)

    def recording(*a, **k):
        outs[id(a[at])] = a[at]
        return real(*a, **k)

    monkeypatch.setattr(fs, name, recording)
    got = _core(sfb, gl, prev)
    monkeypatch.setattr(fs, name, real)
    return got, sum(o["gnp"].sum(0) for o in outs.values())


def test_gamma_normaliser_stays_in_float32_range(monkeypatch):
    """K = 16,384 haplotypes over 32 grids with every SNP's GL informative
    (uniform in [0.001, 1]). Unscaled, a grid's gamma numerators sum to a
    product of up to 7 grids' masses: ~1e-31 here, under the JAX body's
    floor of 1e-30 for the normaliser, which took the dosage up to ~0.9 from
    the fused FB's at K = 98,304. The steps scale grid j's numerators by
    M_{j+1} / M_L, so they sum to sum_k alpha_{L-1} B_{L-1} >= jump / K at
    every grid; the floors are float32's least normal value. Dosage and
    top-K values within 1e-5 of the fused FB, log-likelihood within 1e-5
    (relative), the previous form's too."""
    from quilt_tpu_torch.kernels.fb import fb_full_batched

    rng = np.random.default_rng(16384)
    K, nG = 16384, 32
    words = rng.integers(-2**31, 2**31, (nG, K), dtype=np.int64).astype(np.int32)
    trans = np.tile(np.float32([0.98, 0.02]), (nG, 1))
    trans[0] = (1.0, 1.0)
    thin = np.full(nG, -1, dtype=np.int32)
    thin[::10] = np.arange(len(thin[::10]))
    fb = FBInputs(words=words, trans=trans, thin_flag=thin, K=K, K_pad=K, nGrids=nG,
                  S=nG * 32, nSNPs=nG * 32)
    gl = torch.from_numpy((0.001 + 0.999 * rng.random((3, 2, fb.S))).astype(np.float32))
    d_r, l_r, tv_r, _ = fb_full_batched(gl, fb, K_top=8, family="fused")
    sfb = ShardedFB(fb, make_mesh(1, 2, ["cpu"] * 2))
    thin_g = torch.as_tensor(fb.thin_flag >= 0)
    sums = {}
    for prev in (False, True):
        (d, ll, tv, _), sums[prev] = _gamma_sums(monkeypatch, sfb, gl, prev)
        torch.testing.assert_close(d, d_r, rtol=0, atol=1e-5)
        torch.testing.assert_close(ll, l_r, rtol=1e-5, atol=0)
        torch.testing.assert_close(tv[thin_g][..., :8], tv_r[thin_g], rtol=0, atol=1e-5)
    assert sums[False].min() >= 0.02 / K * 0.999
    assert sums[True].min() < 1e-30


class _AllocRecorder:
    """Stands in for the torch module inside kernels/fb_sharded.py and
    records the shapes it allocates (empty / zeros / ones / full)."""

    def __init__(self):
        self.shapes = []

    def __getattr__(self, name):
        real = getattr(torch, name)
        if name not in ("empty", "zeros", "ones", "full"):
            return real

        def alloc(size, *a, **k):
            self.shapes.append(tuple(size))
            return real(size, *a, **k)
        return alloc


@pytest.mark.parametrize("prev", [False, True])
def test_sharded_core_keeps_a_checkpoint_plane(monkeypatch, prev):
    """The step body allocates the [Gp/L, B, K_shard] checkpoint plane and
    the [Gp/L, B, 2L] scalar plane on each shard and no [Gp, B, K_shard]
    plane; the previous form allocates the [Gp, B, K_shard] alpha planes
    (the recorder sees them)."""
    fb, gl = _fb_world()
    n_panel = 2
    sfb = ShardedFB(fb, make_mesh(1, n_panel, ["cpu"] * n_panel))
    rec = _AllocRecorder()
    monkeypatch.setattr(fs, "torch", rec)
    _core(sfb, gl, prev)
    Gp, B, KS = fb.nGrids, gl.shape[0], sfb.K_shard
    planes = [s for s in rec.shapes if len(s) == 3 and s[1:] == (B, KS)]
    if prev:
        assert planes == [(Gp, B, KS)] * n_panel
    else:
        assert planes == [(Gp // L, B, KS)] * n_panel
        assert rec.shapes.count((Gp // L, B, fs.SCAL_VALS)) == n_panel


@pytest.mark.parametrize("capture", [False, True])
def test_a_call_launches_two_segment_kernels_a_segment_and_shard(monkeypatch, capture):
    """A sharded call on 2 shards (thinned grids with tied gammas, with and
    without capture) calls seg_fwd_local and seg_bwd_local once a shard
    and each step once a segment and shard: 2 (Gp/L + 1) segment launches
    a shard, no apply pass; the top-K lists keep the lower of two tied
    haplotypes first."""
    fb, gl = _fb_world(capture_grid=29 if capture else -1)
    n_panel = 2
    sfb = ShardedFB(fb, make_mesh(1, n_panel, ["cpu"] * n_panel))
    names = ("seg_fwd_local", "seg_fwd_step", "seg_bwd_local", "seg_bwd_step", "seg_fwd_apply",
             "seg_bwd_apply")
    calls = dict.fromkeys(names, 0)
    for n in names:
        def counted(*a, _n=n, _f=getattr(fs, n), **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(fs, n, counted)
    got = sfb(gl)
    NSC = fb.nGrids // L
    assert calls == dict(seg_fwd_local=n_panel, seg_fwd_step=NSC * n_panel,
                         seg_bwd_local=n_panel, seg_bwd_step=NSC * n_panel,
                         seg_fwd_apply=0, seg_bwd_apply=0)
    assert sum(calls.values()) == 2 * (NSC + 1) * n_panel
    assert len(got) == (5 if capture else 4)
    tv, ti = got[2].numpy(), got[3].numpy()
    thin = np.flatnonzero(fb.thin_flag >= 0)
    tied = (tv[thin, :, :-1] == tv[thin, :, 1:]) & (tv[thin, :, :-1] > 0)
    assert tied.any()
    assert (ti[thin, :, :-1][tied] < ti[thin, :, 1:][tied]).all()
