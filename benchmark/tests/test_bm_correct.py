"""The comparison that decides `correct`, at a size a test run holds (the
tiny cell on the CPU, the port's plain kernel versions, the configuration's
own limits): a sound run passes; the control (the reference in bfloat16 in
the program's place) fails; and a run with the timed path broken
underneath comes out not correct, for each fault the cell can have."""
import torch

import quilt_tpu_torch.engine.batch as batch_mod
import quilt_tpu_torch.kernels.gibbs as gibbs_mod
from benchmark.control import control_numbers, plant
from benchmark.harness import run_cell

from conftest import TINY


def _run(root, seed=21, keep=None):
    return run_cell(root, TINY, seed, 0.0, False, device="cpu", keep=keep)


def test_a_sound_run_is_correct(tiny_root):
    res = _run(tiny_root)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == {"sweep_alpha_gap", "wrong_draw_share", "dosage_gap"}


def test_a_batch_imputed_in_groups_is_judged_whole(tiny_root, monkeypatch):
    import quilt_tpu_torch.engine.driver as driver_mod

    # the driver clamps the batch to the chains that fit: groups of 2 and 1
    monkeypatch.setattr(driver_mod, "max_chains", lambda *a, **kw: 2 * 3)
    keep = {}
    res = _run(tiny_root, keep=keep)
    assert keep["state"]["groups"] == [2, 1]
    assert res["correct"], res["checks"]


def test_the_control_is_not_correct(tiny_root):
    keep = {}
    res = _run(tiny_root, keep=keep)
    ctrl = control_numbers(keep, "cpu")
    limits = {k: v["limit"] for k, v in res["checks"].items()}
    failed = [k for k in limits if ctrl[k] > limits[k]]
    assert failed, (ctrl, limits)


def _fb_wrapped(monkeypatch, change):
    real = batch_mod.fb_full_batched

    def broken(gl, *a, **kw):
        out = real(gl, *a, **kw)
        return (change(out[0].clone()),) + tuple(out[1:])

    monkeypatch.setattr(batch_mod, "fb_full_batched", broken)


def test_a_sweep_that_returns_its_state_unchanged_is_caught(tiny_root, monkeypatch):
    real = gibbs_mod.fwd_sweep

    def unchanged(lemg, beta, lem_pad, slots, first, lab, *a, **kw):
        out = real(lemg, beta, lem_pad, slots, first, lab, *a, **kw)
        return (lemg, out[1], slots[:, 1].clone(), out[3], out[4], lab)

    monkeypatch.setattr(gibbs_mod, "fwd_sweep", unchanged)
    res = _run(tiny_root)
    assert not res["correct"], res["checks"]


def test_a_backward_sweep_that_returns_its_state_unchanged_is_caught(tiny_root):
    undo = plant("beta_ones")           # the backward probabilities left at ones
    try:
        res = _run(tiny_root)
    finally:
        undo()
    assert not res["correct"], res["checks"]
    share = res["checks"]["wrong_draw_share"]
    assert share["value"] > share["limit"], res["checks"]


def test_half_the_batch_left_out_is_caught(tiny_root, monkeypatch):
    def half(d):
        n = d.shape[0] // 2
        d[n:] = d[:n].mean(0, keepdim=True)      # the mean over the rest
        return d

    _fb_wrapped(monkeypatch, half)
    res = _run(tiny_root)
    assert not res["correct"], res["checks"]


def test_an_answer_altered_where_it_is_produced_is_caught(tiny_root, monkeypatch):
    def alter(d):
        d[0, 5] = torch.clamp(d[0, 5] + 0.3, max=1.0) if d[0, 5] < 0.7 else d[0, 5] - 0.3
        return d

    _fb_wrapped(monkeypatch, alter)
    res = _run(tiny_root)
    assert not res["correct"], res["checks"]
