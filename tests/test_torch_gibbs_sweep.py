"""Plain PyTorch Gibbs sweeps (quilt_tpu_torch.kernels.gibbs_sweep) vs the
JAX package's Pallas sweeps (_fwd_sweep / _bwd_sweep, interpreted on the
CPU) on identical numpy-made inputs.

Tolerances: read labels agree on > 99.5% of slots (a uniform that lands
within float rounding of a candidate boundary may draw the other label);
logc and lemg rtol 1e-4 / atol 1e-3 (float32 sums taken in another order,
and the port does nothing at a skipped slot, where the Pallas kernel
renormalises alpha by a sum that is 1 within rounding); beta rtol 1e-5.
Both samplers: diploid (nl = 2) and NIPT (nl = 3, with its label prior)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from quilt_tpu.kernels.gibbs_pallas import _bwd_sweep, _fwd_sweep

from quilt_tpu_torch.kernels.gibbs_sweep import CLUSTER, GENERAL, GLOBAL, bwd_sweep, fwd_sweep
from quilt_tpu_torch.simulate import random_sweep_state

torch.set_num_threads(2)

_NAMES = ("lemg", "beta", "lem_pad", "slots", "first_read", "lab_init", "trans", "cnt_max")


def _inputs(seed, G, B, W, K, K_real, max_reads, p_skip=0.05, nl=2):
    state = random_sweep_state(np.random.default_rng(seed), G, B, W, K, K_real, max_reads,
                               p_skip, nl=nl)
    return dict(zip(_NAMES, state))


def _compare_fwd(arrs, K_real, it_mode, want_alpha=True, nl=2, prior=(0.5, 0.5)):
    kw = dict(nl=nl, K_real=K_real, it_mode=it_mode, prior=prior,
              want_alpha=want_alpha)
    ref = _fwd_sweep(*(jnp.asarray(arrs[k]) for k in _NAMES), **kw)
    got = fwd_sweep(*(torch.from_numpy(arrs[k]) for k in _NAMES), **kw)
    ref = [np.asarray(x) for x in ref]
    got = [x.numpy() for x in got]
    slots = arrs["slots"]
    live = slots[:, 2] == 0
    agree = (ref[2][live] == got[2][live]).mean()
    assert agree > 0.995, f"label agreement {agree}"
    np.testing.assert_array_equal(ref[2][~live], got[2][~live])
    np.testing.assert_allclose(got[3], ref[3], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got[5], ref[5], rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(got[4], ref[4])
    if want_alpha:
        np.testing.assert_allclose(got[1], ref[1], rtol=1e-4, atol=1e-6)
    return ref, got


@pytest.mark.parametrize("it_mode", [0, 1, 2])
def test_fwd_sweep_matches_pallas(it_mode):
    arrs = _inputs(seed=3 + it_mode, G=7, B=3, W=6, K=40, K_real=36,
                   max_reads=6)
    _compare_fwd(arrs, K_real=36, it_mode=it_mode)


def test_fwd_sweep_wide_slot_axis():
    """More than 64 reads in a grid: the Pallas kernel tiles the slot axis
    in 64-wide chunks, the port runs one read loop; same draws."""
    arrs = _inputs(seed=11, G=3, B=2, W=128, K=24, K_real=24, max_reads=90)
    assert arrs["cnt_max"].max() > 64
    _compare_fwd(arrs, K_real=24, it_mode=2, want_alpha=False)


@pytest.mark.parametrize("it_mode", [0, 1, 2])
def test_fwd_sweep_mostly_skipped_slots(it_mode):
    """Most slots empty or uninformative: the port does nothing at a
    skipped slot, where the Pallas kernel still renormalises alpha by a
    sum that is 1 within rounding and adds its log to logc."""
    arrs = _inputs(seed=21 + it_mode, G=9, B=3, W=24, K=40, K_real=36,
                   max_reads=6, p_skip=0.5)
    assert (arrs["slots"][:, 2] > 0).mean() > 0.8
    _compare_fwd(arrs, K_real=36, it_mode=it_mode)


def _torch_fwd(arrs, K_real, it_mode=2):
    return [x.numpy() for x in fwd_sweep(
        *(torch.from_numpy(arrs[k]) for k in _NAMES), nl=2, K_real=K_real,
        it_mode=it_mode, prior=(0.5, 0.5))]


def test_fwd_sweep_skipped_slot_changes_nothing():
    """A skipped slot leaves the whole state bit-identical: a sweep over
    skipped slots only returns lemg, the labels and the counts as they
    came, and what a skipped slot holds (emissions, uniform, label) moves
    no bit of the other outputs."""
    arrs = _inputs(seed=31, G=6, B=3, W=8, K=24, K_real=20, max_reads=5, p_skip=0.4)
    skipped = arrs["slots"][:, 2] > 0
    assert skipped.any() and not skipped.all()
    rng = np.random.default_rng(32)
    other = {k: v.copy() for k, v in arrs.items()}
    noise = rng.uniform(-6.0, 0.0, arrs["lem_pad"].shape).astype(np.float32)
    other["lem_pad"] = np.where(skipped[..., None], noise, arrs["lem_pad"])
    other["slots"][:, 0] = np.where(
        skipped, rng.random(skipped.shape).astype(np.float32).view(np.int32),
        arrs["slots"][:, 0])
    got, got_other = _torch_fwd(arrs, 20), _torch_fwd(other, 20)
    for a, b in zip(got, got_other):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[2][skipped], arrs["slots"][:, 1][skipped])
    idle = {k: v.copy() for k, v in arrs.items()}
    idle["slots"][:, 2] = 1
    out = _torch_fwd(idle, 20)
    np.testing.assert_array_equal(out[0], idle["lemg"])
    np.testing.assert_array_equal(out[2], idle["slots"][:, 1])
    np.testing.assert_array_equal(out[5], idle["lab_init"])
    assert not out[4].any()


def test_bwd_sweep_matches_pallas():
    rng = np.random.default_rng(5)
    G, BN, K, K_real = 9, 6, 40, 33
    lemg = rng.uniform(-30.0, 0.0, size=(G, BN, K)).astype(np.float32)
    trans = np.stack([rng.uniform(0.9, 0.999, G),
                      rng.uniform(0.001, 0.1, G)]).astype(np.float32)
    ref = np.asarray(_bwd_sweep(jnp.asarray(lemg), jnp.asarray(trans),
                                nl=2, K_real=K_real))
    got = bwd_sweep(torch.from_numpy(lemg), torch.from_numpy(trans),
                    nl=2, K_real=K_real).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("prior", [(0.5, 0.4, 0.1), (0.5, 0.5, 0.0)])
@pytest.mark.parametrize("it_mode", [0, 1, 2])
def test_fwd_sweep_nipt_matches_pallas(it_mode, prior):
    """nl = 3 with the NIPT label prior; at fetal fraction 0 the third
    label has prior 0 and is never drawn."""
    arrs = _inputs(seed=41 + it_mode, G=7, B=3, W=6, K=40, K_real=36, max_reads=6, nl=3)
    _, got = _compare_fwd(arrs, K_real=36, it_mode=it_mode, nl=3, prior=prior)
    live = arrs["slots"][:, 2] == 0
    drawn = got[2][live] != arrs["slots"][:, 1][live]
    assert drawn.any()
    if prior[2] == 0.0:
        assert not (got[2][live][drawn] == 2).any()
    else:
        assert (got[2][live][drawn] == 2).any()


def test_fwd_sweep_nipt_mostly_skipped_slots():
    arrs = _inputs(seed=51, G=9, B=3, W=24, K=40, K_real=36, max_reads=6, p_skip=0.5, nl=3)
    assert (arrs["slots"][:, 2] > 0).mean() > 0.8
    _compare_fwd(arrs, K_real=36, it_mode=2, nl=3, prior=(0.5, 0.45, 0.05))


@pytest.mark.parametrize("nl", [2, 3])
def test_fwd_sweep_no_reads_is_the_alpha_recursion(nl):
    """cnt_max = 0 everywhere: the sweep is the plain forward recursion that
    the NIPT block move re-runs; lemg and the labels come back as they went."""
    arrs = _inputs(seed=61, G=8, B=2, W=4, K=24, K_real=20, max_reads=4, nl=nl)
    arrs["cnt_max"] = np.zeros_like(arrs["cnt_max"])
    prior = (0.5, 0.5) if nl == 2 else (0.5, 0.4, 0.1)
    _, got = _compare_fwd(arrs, K_real=20, it_mode=2, nl=nl, prior=prior)
    np.testing.assert_array_equal(got[0], arrs["lemg"])
    np.testing.assert_array_equal(got[2], arrs["slots"][:, 1])
    np.testing.assert_allclose(got[1][:, :, :20].sum(2), 1.0, rtol=1e-5)


def test_bwd_sweep_nipt_matches_pallas():
    rng = np.random.default_rng(6)
    G, BN, K, K_real = 9, 9, 40, 33
    lemg = rng.uniform(-30.0, 0.0, size=(G, BN, K)).astype(np.float32)
    trans = np.stack([rng.uniform(0.9, 0.999, G),
                      rng.uniform(0.001, 0.1, G)]).astype(np.float32)
    ref = np.asarray(_bwd_sweep(jnp.asarray(lemg), jnp.asarray(trans),
                                nl=3, K_real=K_real))
    got = bwd_sweep(torch.from_numpy(lemg), torch.from_numpy(trans),
                    nl=3, K_real=K_real).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


def test_chained_sweeps_with_skipped_slots_keep_logc():
    """21 forward / backward sweeps chained at ~52% skipped slots: the port
    does nothing at a skipped slot where the Pallas kernel renormalises, and
    the difference must not build up. Compared where the chains' labels
    still agree (a chain that drew another label at a rounding boundary has
    forked for good): logc within the Gibbs tolerance rtol 1e-4 / atol 1e-3
    after the last sweep."""
    G, B, K, K_real, n_sweeps = 10, 4, 40, 36, 21
    rng = np.random.default_rng(72)
    arrs = dict(zip(_NAMES, random_sweep_state(
        np.random.default_rng(71), G, B, 5, K, K_real, 5, p_skip=0.4,
        counts=rng.integers(3, 6, size=(G, B)))))
    share = (arrs["slots"][:, 2] > 0).mean()
    assert 0.45 < share < 0.6, share
    j = {k: jnp.asarray(v) for k, v in arrs.items()}
    t = {k: torch.from_numpy(v.copy()) for k, v in arrs.items()}
    kw = dict(nl=2, K_real=K_real, it_mode=2, prior=(0.5, 0.5), want_alpha=False)
    for _ in range(n_sweeps):
        u = rng.random(arrs["slots"][:, 0].shape).astype(np.float32).view(np.int32)
        sj = np.array(j["slots"])
        sj[:, 0] = u
        st = t["slots"].numpy().copy()
        st[:, 0] = u
        j["slots"], t["slots"] = jnp.asarray(sj), torch.from_numpy(st)
        rj = _fwd_sweep(*(j[k] for k in _NAMES), **kw)
        rt = fwd_sweep(*(t[k] for k in _NAMES), **kw)
        j["lemg"], j["lab_init"] = rj[0], rj[5]
        t["lemg"], t["lab_init"] = rt[0], rt[5]
        j["slots"] = jnp.asarray(sj).at[:, 1].set(rj[2])
        st[:, 1] = rt[2].numpy()
        t["slots"] = torch.from_numpy(st)
        j["beta"] = _bwd_sweep(j["lemg"], j["trans"], nl=2, K_real=K_real)
        t["beta"] = bwd_sweep(t["lemg"], t["trans"], nl=2, K_real=K_real)
    same = (np.asarray(j["slots"])[:, 1] == t["slots"].numpy()[:, 1]).all(axis=(0, 1))   # [B]
    assert same.sum() >= B - 1, same
    rows = np.concatenate([same, same])
    np.testing.assert_allclose(rt[3].numpy()[rows], np.asarray(rj[3])[rows], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(t["beta"].numpy()[:, rows], np.asarray(j["beta"])[:, rows],
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("nl,BN", [(4, 8), (3, 8), (1, 4)])
def test_sweeps_refuse_other_row_counts(nl, BN):
    lemg = torch.zeros((2, BN, 8))
    trans = torch.ones((2, 2))
    with pytest.raises(ValueError, match="nl must be 2 or 3"):
        bwd_sweep(lemg, trans, nl=nl, K_real=8)


@pytest.mark.parametrize("K,nl,fwd,bwd", [
    (640, 2, 128, 128),                 # the main path's K: 128 chain threads, registers
    (640, 3, 128, 128),
    (10240, 2, GENERAL, GENERAL),       # the general variant's last K
    (10240, 3, CLUSTER, GENERAL),       # NL = 3: no ring stage fits past 8,155
    (8192, 3, CLUSTER, GENERAL),        # the wide NIPT path's Ksubset
    (10368, 2, CLUSTER, CLUSTER),       # the wide path's Ksubset
    (10368, 3, CLUSTER, CLUSTER),
    (12288, 2, CLUSTER, CLUSTER),       # the timing shape
    (12288, 3, CLUSTER, CLUSTER),       # the cluster form's last K at NL = 3
    (12416, 3, GLOBAL, CLUSTER),        # and the next padded K
    (16384, 2, CLUSTER, CLUSTER),       # its last K at NL = 2
    (16512, 2, GLOBAL, GLOBAL),
    (40960, 2, GLOBAL, GLOBAL),
    (40960, 3, GLOBAL, GLOBAL),
])
def test_host_form_choices(K, nl, fwd, bwd):
    """The sweep kernels' form codes as the wrappers name them: the forms
    that ran before where they hold K (registers up to 2,048, the general
    variant up to 10,240 while, forward, one grid stage of 2 nl rows and a
    read row fit the 227 KB - 4 KB of shared memory), the cluster forms
    past them up to their capacity (forward: 8 blocks x 256 threads x 8
    columns, 6 at nl = 3; backward: 16,384 columns, at any row count), the
    global form past that; nothing raises at any K."""
    from quilt_tpu_torch.kernels.gibbs_sweep import bwd_form, fwd_form, fwd_scratch_floats

    assert fwd_form(K, nl) == fwd and bwd_form(K) == bwd
    assert fwd_scratch_floats(K, nl) == (nl * K if fwd == GLOBAL else 0)


@pytest.mark.parametrize("nl,K", [
    pytest.param(2, 10368, id="2"),          # the wide path's Ksubset
    pytest.param(3, 10368, id="3"),
    pytest.param(2, 16384, id="2-K16384"),   # the cluster forms' capacity
    pytest.param(3, 12288, id="3-K12288"),   # the forward's at NL = 3
    pytest.param(2, 12288, id="2-K12288"),
])
def test_sweeps_match_pallas_past_the_shared_memory_forms(nl, K):
    """K past the general variant (G = 2, B = 1), where the card takes the
    cluster forms (the backward's up to 16,384) or the global forms: the
    plain sweeps against the interpreted Pallas sweeps, at the tolerances
    of the small shapes."""
    prior = (0.5, 0.5) if nl == 2 else (0.5, 0.4, 0.1)
    K_real = K - 68
    arrs = _inputs(seed=40 + nl, G=2, B=1, W=3, K=K, K_real=K_real, max_reads=3, nl=nl)
    _compare_fwd(arrs, K_real=K_real, it_mode=2, nl=nl, prior=prior)
    ref = _bwd_sweep(jnp.asarray(arrs["lemg"]), jnp.asarray(arrs["trans"]), nl=nl,
                     K_real=K_real)
    got = bwd_sweep(torch.from_numpy(arrs["lemg"]), torch.from_numpy(arrs["trans"]), nl=nl,
                    K_real=K_real)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
