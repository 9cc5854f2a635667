"""The read arrays of a batch: SampleReads.subset / sorted_by_grid and
PaddedReads.build / build_batched (numpy gathers over the flat read arrays)
equal, bit for bit, a per-read oracle kept here: the constructors as they
copied one read at a time. Every returned array has the oracle's dtype,
shape and bytes, padding zeros included."""
import dataclasses

import numpy as np
import pytest
import torch

from quilt_tpu_torch.inputs import PaddedReads, pad_to_multiple
from quilt_tpu_torch.io.reads import SampleReads, bq_to_probs

torch.set_num_threads(2)


# --- the per-read oracle -------------------------------------------------

def _oracle_subset(self, order):
    lens = np.diff(self.offsets)[order]
    new_off = np.zeros(len(order) + 1, dtype=np.int64)
    np.cumsum(lens, out=new_off[1:])
    u = np.empty(int(new_off[-1]), dtype=np.int32)
    bq = np.empty(int(new_off[-1]), dtype=np.int16)
    for i, r in enumerate(order):
        s, e = self.offsets[r], self.offsets[r + 1]
        u[new_off[i]:new_off[i + 1]] = self.u[s:e]
        bq[new_off[i]:new_off[i + 1]] = self.bq[s:e]
    return SampleReads(
        u=u,
        bq=bq,
        offsets=new_off,
        wif0=self.wif0[order],
        qname=None if self.qname is None else self.qname[order],
    )


def _oracle_sorted_by_grid(self):
    order = np.argsort(self.wif0, kind="stable")
    return _oracle_subset(self, order)


def _oracle_build(reads, ref_error=0.001, Jmax=10000):
    nReads = reads.nReads
    lens = np.minimum(np.diff(reads.offsets), Jmax + 1).astype(np.int64)
    J = max(int(lens.max()) if nReads else 1, 1)
    u_pad = np.zeros((nReads, J), dtype=np.int32)
    lr = np.zeros((nReads, J), dtype=np.float32)
    la = np.zeros((nReads, J), dtype=np.float32)
    lpr = np.zeros((nReads, J), dtype=np.float32)
    lpa = np.zeros((nReads, J), dtype=np.float32)
    mask = np.zeros((nReads, J), dtype=bool)
    probs = bq_to_probs(reads.bq)
    t_ref = probs[:, 0] * (1 - ref_error) + probs[:, 1] * ref_error
    t_alt = probs[:, 1] * (1 - ref_error) + probs[:, 0] * ref_error
    log_tr = np.log(t_ref)
    log_ta = np.log(t_alt)
    log_pr = np.log(np.maximum(probs[:, 0], 1e-30))
    log_pa = np.log(np.maximum(probs[:, 1], 1e-30))
    zero = reads.bq == 0
    log_pr = np.where(zero, 0.0, log_pr)
    log_pa = np.where(zero, 0.0, log_pa)
    for r in range(nReads):
        s = reads.offsets[r]
        n = lens[r]
        u_pad[r, :n] = reads.u[s:s + n]
        lr[r, :n] = log_tr[s:s + n]
        la[r, :n] = log_ta[s:s + n]
        lpr[r, :n] = log_pr[s:s + n]
        lpa[r, :n] = log_pa[s:s + n]
        mask[r, :n] = True
    return PaddedReads(u_pad=u_pad, lr=lr, la=la, mask=mask,
                       wif0=reads.wif0.astype(np.int32), nReads=nReads, J=J,
                       lpr=lpr, lpa=lpa)


def _oracle_build_batched(reads_list, ref_error=0.001, Jmax=10000, R_pad_to=64):
    built = [_oracle_build(r, ref_error, Jmax) for r in reads_list]
    R = pad_to_multiple(max(b.nReads for b in built), R_pad_to)
    J = max(b.J for b in built)
    n = len(built)
    u = np.zeros((n, R, J), dtype=np.int32)
    lr = np.zeros((n, R, J), dtype=np.float32)
    la = np.zeros((n, R, J), dtype=np.float32)
    lpr = np.zeros((n, R, J), dtype=np.float32)
    lpa = np.zeros((n, R, J), dtype=np.float32)
    mask = np.zeros((n, R, J), dtype=bool)
    wif0 = np.zeros((n, R), dtype=np.int32)
    for i, b in enumerate(built):
        u[i, : b.nReads, : b.J] = b.u_pad
        lr[i, : b.nReads, : b.J] = b.lr
        la[i, : b.nReads, : b.J] = b.la
        lpr[i, : b.nReads, : b.J] = b.lpr
        lpa[i, : b.nReads, : b.J] = b.lpa
        mask[i, : b.nReads, : b.J] = b.mask
        wif0[i, : b.nReads] = b.wif0
    return PaddedReads(u_pad=u, lr=lr, la=la, mask=mask, wif0=wif0,
                       nReads=R, J=J, lpr=lpr, lpa=lpa)


# --- samples -------------------------------------------------------------

def _sample(rng, n_reads, lens=(2, 4), nSNPs=500, n_grids=16, zero_len=0.0,
            bq_zero=0.0, qname=False, sort=False):
    """Random flat reads: lengths in [lens[0], lens[1]], a share of empty
    reads, a share of bq == 0 bases, wif0 with many ties."""
    n = rng.integers(lens[0], lens[1] + 1, n_reads)
    n[rng.random(n_reads) < zero_len] = 0
    offsets = np.zeros(n_reads + 1, dtype=np.int64)
    np.cumsum(n, out=offsets[1:])
    nb = int(offsets[-1])
    u = rng.integers(0, nSNPs, nb).astype(np.int32)
    bq = (rng.choice([-1, 1], nb) * rng.integers(1, 41, nb)).astype(np.int16)
    bq[rng.random(nb) < bq_zero] = 0
    wif0 = rng.integers(0, n_grids, n_reads).astype(np.int32)
    if sort:
        wif0.sort()
    names = np.array([f"read{i}" for i in range(n_reads)]) if qname else None
    return SampleReads(u=u, bq=bq, offsets=offsets, wif0=wif0, qname=names)


CASES = {
    "empty": dict(samples=[dict(n_reads=0)]),
    "zero_length_reads": dict(samples=[dict(n_reads=300, lens=(0, 3), zero_len=0.3)]),
    "all_reads_empty": dict(samples=[dict(n_reads=20, lens=(0, 0))]),
    "truncated_past_Jmax": dict(samples=[dict(n_reads=200, lens=(1, 12))], Jmax=4),
    "bq_zero_bases": dict(samples=[dict(n_reads=300, bq_zero=0.2)]),
    "wif0_ties": dict(samples=[dict(n_reads=400, n_grids=3)]),
    "already_sorted": dict(samples=[dict(n_reads=300, sort=True)]),
    "qname_present": dict(samples=[dict(n_reads=250, qname=True, zero_len=0.1)]),
    "batch_of_samples": dict(samples=[dict(n_reads=0), dict(n_reads=70, lens=(1, 2)),
                                      dict(n_reads=300, lens=(2, 9), qname=True),
                                      dict(n_reads=129, lens=(0, 5), zero_len=0.2, bq_zero=0.1)]),
    "cov1x_sample": dict(samples=[dict(n_reads=6_550, lens=(2, 3), nSNPs=16_384,
                                       n_grids=512, bq_zero=0.01)]),
}


def _same(a, b, what):
    """Equal types, dtypes, shapes and bytes of every field."""
    assert type(a) is type(b), what
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert isinstance(x, np.ndarray) and isinstance(y, np.ndarray), (what, f.name)
            assert x.dtype == y.dtype and x.shape == y.shape, (what, f.name, x.dtype, y.dtype)
            if x.dtype.kind in "UO":
                assert np.array_equal(x, y), (what, f.name)
            else:
                assert x.tobytes() == y.tobytes(), (what, f.name)
        else:
            assert type(x) is type(y) and x == y, (what, f.name, x, y)


@pytest.mark.parametrize("case", list(CASES))
def test_read_arrays_equal_the_per_read_oracle(case):
    spec = CASES[case]
    Jmax = spec.get("Jmax", 10000)
    rng = np.random.default_rng(list(CASES).index(case))
    samples = [_sample(rng, **s) for s in spec["samples"]]
    for i, reads in enumerate(samples):
        _same(reads.sorted_by_grid(), _oracle_sorted_by_grid(reads), f"sorted {i}")
        # a subset in another order, and downsample_reads' kept reads
        order = rng.permutation(reads.nReads)[: reads.nReads * 2 // 3]
        _same(reads.subset(order), _oracle_subset(reads, order), f"subset {i}")
        kept = np.flatnonzero(rng.random(reads.nReads) < 0.5)
        _same(reads.subset(kept), _oracle_subset(reads, kept), f"kept {i}")
        _same(PaddedReads.build(reads, 0.001, Jmax), _oracle_build(reads, 0.001, Jmax),
              f"build {i}")
    rs = [r.sorted_by_grid() for r in samples]
    _same(PaddedReads.build_batched(rs, ref_error=0.001, Jmax=Jmax),
          _oracle_build_batched(rs, ref_error=0.001, Jmax=Jmax), "build_batched")
