"""Gibbs forward and backward sweeps: CUDA kernels and their plain versions.

Counterparts of quilt_tpu/kernels/gibbs_pallas.py:_fwd_sweep (Pallas kernel
_make_fwd_kernel) and :_bwd_sweep (_make_bwd_kernel), with the JAX
functions' signatures and nl-major [G, nl*B, K] layouts (state row h*B + b).
The CUDA kernels are csrc/gibbs_sweep.cu; the plain PyTorch versions below
compute the same function and serve the CPU (and the kernel checks).

On the card a sweep is bound by its dependent chain: one step per grid plus
one per live read slot, each needing sums over all K haplotypes before the
next can start. The kernels therefore keep a chain's state in the registers
of 128 threads (one block per chain forward, per state row backward), take
exactly one reduction (one butterfly, one named barrier) per step, and leave
every device-memory load to producer warps that run ahead of the chain and
fill shared-memory rings. The wrapper names the form (`fwd_form`, `bwd_form`):
the smallest register variant that holds K, above K = 2,048 the general
variant with the state in per-thread local arrays (forward: while one grid
stage and one read row fit the shared-memory rings), past those a cluster
form (one chain, or backward one state row, on a thread-block cluster of 8
blocks, each a register form over its eighth of the columns with its own
producer warp; the blocks exchange each step's sums over distributed shared
memory, csrc/cluster_xchg.cuh; its own launch counts
`FWD_CLUSTER_KERNELS[nl]`, `BWD_CLUSTER_KERNEL`), and past that a global
form that takes any K device memory holds (the state in a global scratch
plane, rows read straight from device memory, no ring; its own launch
counts `FWD_GLOBAL_KERNELS[nl]`, `BWD_GLOBAL_KERNEL`). A form is never
replaced by another: the C entry refuses one that does not hold K (and a
cluster the card cannot schedule). The forms and the K they take:

    registers  K <= 2,048           128 threads x 2 / 4 / 5 / 8, 256 x 8
    general    K <= 10,240          forward at nl = 3 only to K = 8,155
    cluster    K <= 16,384 (nl 2)   forward: 8 blocks x 256 threads x 8 columns
               K <= 12,288 (nl 3)   (x 6 columns at nl = 3)
               K <= 16,384          backward: 8 blocks x 256 x 8 or 128 x 16
                                    (the launcher's plan: fewest waves)
    global     any K

A skipped slot (empty, or an uninformative read) is no step at all: it
cannot flip and changes no state, and both the kernel and `fwd_sweep_plain`
leave alpha, pC and logc untouched there, where the Pallas kernel
renormalises by a sum that is 1 within float32 rounding.

Both samplers run through them: the diploid one (nl = 2 latent rows a
chain, prior (0.5, 0.5)) and the NIPT one (nl = 3, prior (0.5, (1-ff)/2,
ff/2)); the forward kernel is instantiated for each and takes the prior
from the caller, the backward kernel works on state rows and takes any
nl. Each nl has its own launch count (`FWD_KERNELS[nl]`, `BWD_KERNELS[nl]`).

The private `_variant` argument is for timings and tests only (64, 128 or
256: that many chain threads, as far as instantiated; -1: the general
variant wherever it holds K; GLOBAL: the global form at any K, timed in
turn with the cluster form it gave way to), as are `_ahead` (the backward
step's look-ahead form), `_shape` (the backward cluster form's shape and
ring in place of the plan's) and `_wide` (nl = 3: a step's 9 or 12 values
reduced as one reduction of 16 instead of two of at most 8); the engine
never passes them.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .._build import Kernel, check_tensor as _check

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = [_P] * 15 + [_I] * 10 + [_F] * 4
_BWD_ARGS = [_P] * 3 + [_I] * 6 + [_F]
# one launch count per sampler: the same C entries serve nl = 2 and nl = 3
FWD_KERNELS = {2: Kernel("gibbs_sweep", "gibbs_fwd", _FWD_ARGS),
               3: Kernel("gibbs_sweep", "gibbs_fwd", _FWD_ARGS, name="gibbs_fwd_nl3")}
BWD_KERNELS = {2: Kernel("gibbs_sweep", "gibbs_bwd", _BWD_ARGS),
               3: Kernel("gibbs_sweep", "gibbs_bwd", _BWD_ARGS, name="gibbs_bwd_nl3")}
FWD_GLOBAL_KERNELS = {nl: Kernel("gibbs_sweep", "gibbs_fwd", _FWD_ARGS, name=f"gibbs_fwd_global{sfx}")
                      for nl, sfx in ((2, ""), (3, "_nl3"))}
FWD_CLUSTER_KERNELS = {nl: Kernel("gibbs_sweep", "gibbs_fwd", _FWD_ARGS,
                                  name=f"gibbs_fwd_cluster{sfx}")
                       for nl, sfx in ((2, ""), (3, "_nl3"))}
# the backward works on state rows and never sees nl: one count for its global
# form and one for its cluster form
BWD_GLOBAL_KERNEL = Kernel("gibbs_sweep", "gibbs_bwd", _BWD_ARGS, name="gibbs_bwd_global")
BWD_CLUSTER_KERNEL = Kernel("gibbs_sweep", "gibbs_bwd", _BWD_ARGS, name="gibbs_bwd_cluster")
# measurement only: the cluster form with its per-block clock counts, and its plan
BWD_CLUSTER_SPLIT_KERNEL = Kernel("gibbs_sweep", "gibbs_bwd_cluster_split",
                                  [_P] * 4 + [_I] * 5 + [_F])
_BWD_CLUSTER_PLAN = Kernel("gibbs_sweep", "gibbs_bwd_cluster_plan", [_I] * 3 + [_P])
FWD_KERNEL, BWD_KERNEL = FWD_KERNELS[2], BWD_KERNELS[2]
FLOOR_KERNEL = Kernel("gibbs_sweep", "gibbs_chain_floor", [_P] + [_I] * 4)
CLUSTER_FLOOR_KERNEL = Kernel("gibbs_sweep", "gibbs_cluster_floor", [_P] + [_I] * 3)
_NEG = -1e30
# dynamic shared memory a block may take (csrc/gibbs_sweep.cu SMEM_LIMIT): the
# forward's rings shrink to one grid stage (2 * nl rows of K floats) and one
# read row before the general variant gives way to the global form
_SMEM_LIMIT = 227 * 1024 - 4096
# the register variants, (chain threads, columns a thread), in the order the
# dispatch tries them; the general variant's capacity
_REGISTER_PAIRS = ((128, 2), (128, 4), (128, 5), (128, 8), (256, 8))
_GENERAL_COLS = 256 * 40
# the forward's cluster form (csrc/gibbs_sweep.cu CLUSTER_C, CLUSTER_NT): 8
# blocks a chain of 256 chain threads, 8 columns a thread (6 at nl = 3)
_CLUSTER_C = 8
_CLUSTER_COLS = {2: _CLUSTER_C * 256 * 8, 3: _CLUSTER_C * 256 * 6}
# the backward's cluster form (csrc/gibbs_sweep.cu BWD_SHAPES): 16,384 columns
# in each of its shapes
_BWD_CLUSTER_COLS = 16384


# the form codes the C entries read (csrc/gibbs_sweep.cu, csrc/nipt_bank.cu):
# a positive code is a register form (chain threads for the sweeps, columns
# a thread for the bank), GENERAL the state in shared memory or local arrays,
# GLOBAL the state in a global scratch plane, CLUSTER one chain on a
# thread-block cluster, each block a register form over a slice of the columns
GENERAL, GLOBAL, CLUSTER = -1, -2, -3


def _register_form(K: int) -> Optional[int]:
    return next((t for t, c in _REGISTER_PAIRS if K <= t * c), None)


def fwd_form(K: int, nl: int) -> int:
    """The form code of the forward sweep kernel at (padded) K haplotypes
    and nl latent rows, as csrc/gibbs_sweep.cu dispatches it: chain threads
    of a register form up to 2,048, GENERAL while the general variant holds
    K (10,240) and one grid stage and one read row fit shared memory (8,155
    at nl = 3), CLUSTER up to 16,384 (12,288 at nl = 3), else GLOBAL."""
    form = _register_form(K)
    if form is not None:
        return form
    if K <= _GENERAL_COLS and 4 * (2 * nl + 1) * K <= _SMEM_LIMIT:
        return GENERAL
    return CLUSTER if K <= _CLUSTER_COLS[nl] else GLOBAL


def bwd_form(K: int) -> int:
    """The form code of the backward sweep kernel at K haplotypes: chain
    threads of a register form up to 2,048, GENERAL up to 10,240 (its ring
    of e rows shrinks to one row of K floats, which fits up to 57,088),
    CLUSTER up to 16,384 (faster than GLOBAL at every row count timed, 16
    to 112; the launcher picks its shape by the rows), else GLOBAL."""
    form = _register_form(K)
    if form is not None:
        return form
    if K <= _GENERAL_COLS:
        return GENERAL
    return CLUSTER if K <= _BWD_CLUSTER_COLS else GLOBAL


def fwd_scratch_floats(K: int, nl: int) -> int:
    """Floats of scratch a chain of the forward sweep takes at K: its alpha
    [nl, K] in the global form, none in the others (the cluster form's
    state is in its blocks' registers)."""
    return nl * K if fwd_form(K, nl) == GLOBAL else 0


def _check_nl(nl: int, BN: int, prior=None) -> None:
    if nl not in (2, 3) or BN % nl:
        raise ValueError(f"nl must be 2 or 3 and divide the {BN} state rows, got {nl}")
    if prior is not None and (len(prior) != nl or min(prior) < 0 or not sum(prior) > 0):
        raise ValueError(f"prior must hold {nl} non-negative weights, got {prior}")


def fwd_sweep(lemg, beta, lem_pad, slots, first_read, lab_init, trans,
              cnt_max, nl, K_real, it_mode, prior, want_alpha=True, _variant=None,
              _wide=False):
    """One forward Gibbs sweep.

    lemg/beta [G, BN, K] f32; lem_pad [G, W, B, K] f32 (the kernel keeps
    the per-read log emissions in float32); slots [G, 4, W, B] i32 (planes:
    uniform bits / label / skip / read id); first_read [B, 1] i32; lab_init
    [B, nl] f32; trans [2, G] f32; cnt_max [1, G] i32. Returns
    (lemg', alphas, H_pad', logc [BN, 1], uf [B, 1], lab [B, nl]); with
    want_alpha=False alphas is a [1, BN, K] placeholder.

    Inputs on the CPU run the plain version; CUDA tensors launch the
    kernel in the form fwd_form(K, nl) names (the global form with a
    scratch plane of [B, nl, K] floats)."""
    G, BN, K = lemg.shape
    _check_nl(nl, BN, prior)
    B = BN // nl
    W = lem_pad.shape[1]
    f32, i32 = torch.float32, torch.int32
    dev = lemg.device
    _check(lemg, "lemg", f32, (G, BN, K), dev)
    _check(beta, "beta", f32, (G, BN, K), dev)
    _check(lem_pad, "lem_pad", f32, (G, W, B, K), dev)
    _check(slots, "slots", i32, (G, 4, W, B), dev)
    _check(first_read, "first_read", i32, (B, 1), dev)
    _check(lab_init, "lab_init", f32, (B, nl), dev)
    _check(trans, "trans", f32, (2, G), dev)
    _check(cnt_max, "cnt_max", i32, (1, G), dev)
    if not 0 < K_real <= K or it_mode not in (0, 1, 2):
        raise ValueError(f"bad K_real={K_real} / it_mode={it_mode}")
    if dev.type == "cpu":
        return fwd_sweep_plain(lemg, beta, lem_pad, slots, first_read,
                               lab_init, trans, cnt_max, K_real, it_mode,
                               want_alpha, nl=nl, prior=prior)
    threads = fwd_form(K, nl) if _variant is None else _variant
    kernel = {GLOBAL: FWD_GLOBAL_KERNELS, CLUSTER: FWD_CLUSTER_KERNELS}.get(threads, FWD_KERNELS)[nl]
    scratch = torch.empty((B, nl, K) if threads == GLOBAL else (1,), dtype=f32, device=dev)
    lemg_out = torch.empty_like(lemg)
    alphas = torch.empty((G if want_alpha else 1, BN, K), dtype=f32, device=dev)
    h_out = torch.empty((G, W, B), dtype=i32, device=dev)
    logc = torch.empty((BN, 1), dtype=f32, device=dev)
    uf = torch.empty((B, 1), dtype=f32, device=dev)
    lab = torch.empty((B, nl), dtype=f32, device=dev)
    p = [float(x) for x in prior] + [0.0] * (3 - nl)
    kernel.launch(
        lemg.data_ptr(), beta.data_ptr(), lem_pad.data_ptr(),
        slots.data_ptr(), first_read.data_ptr(), lab_init.data_ptr(),
        trans.data_ptr(), cnt_max.data_ptr(), lemg_out.data_ptr(),
        alphas.data_ptr(), h_out.data_ptr(), logc.data_ptr(), uf.data_ptr(),
        lab.data_ptr(), scratch.data_ptr(), G, B, W, K, K_real, it_mode, int(want_alpha),
        threads, nl, int(_wide), 1.0 / K_real, *p,
    )
    return lemg_out, alphas, h_out, logc, uf, lab


def bwd_sweep(lemg, trans, nl, K_real, _variant=None, _ahead=False, _shape=0):
    """Reverse-grid beta recursion from lemg [G, BN, K]: a max-shifted
    emission, then t0*e*beta + t1*sum(e*beta)/K, max-normalised per row.
    Returns beta [G, BN, K]. `_shape` (timings only) names the cluster
    form's shape and ring as shape * 100 + depth in place of the plan's."""
    G, BN, K = lemg.shape
    _check_nl(nl, BN)
    dev = lemg.device
    _check(lemg, "lemg", torch.float32, (G, BN, K), dev)
    _check(trans, "trans", torch.float32, (2, G), dev)
    if not 0 < K_real <= K:
        raise ValueError(f"bad K_real={K_real}")
    if dev.type == "cpu":
        return bwd_sweep_plain(lemg, trans, K_real)
    threads = bwd_form(K) if _variant is None else _variant
    kernel = {GLOBAL: BWD_GLOBAL_KERNEL, CLUSTER: BWD_CLUSTER_KERNEL}.get(threads, BWD_KERNELS[nl])
    beta = torch.empty_like(lemg)
    kernel.launch(lemg.data_ptr(), trans.data_ptr(), beta.data_ptr(), G, BN, K, K_real, threads,
                  _shape if threads == CLUSTER else int(_ahead), 1.0 / K_real)
    return beta


def bwd_cluster_plan(K: int, rows: int, device, shape: int = 0) -> dict:
    """The backward cluster form's launch at K and `rows` state rows as
    csrc/gibbs_sweep.cu plans it (or, shape = shape * 100 + ring depth, that
    one): shape, chain threads, columns a thread, blocks a cluster, ring
    depth, and the clusters the card holds at once."""
    if torch.device(device).type != "cuda":
        raise ValueError("bwd_cluster_plan reads the card and needs a CUDA device")
    out = (ctypes.c_int * 6)()
    _BWD_CLUSTER_PLAN.launch(K, rows, shape, ctypes.addressof(out))
    return dict(zip(("shape", "threads", "cols", "blocks", "depth", "active"), out))


def bwd_cluster_split(lemg, trans, K_real, _shape=0):
    """Measurement only: the cluster form of the backward sweep with, for
    every block, the clock cycles of its chain, its ring waits, block
    reductions and exchanges. Returns (beta, split [BN, blocks, 4])."""
    G, BN, K = lemg.shape
    C = bwd_cluster_plan(K, BN, lemg.device, _shape)["blocks"]
    beta = torch.empty_like(lemg)
    split = torch.zeros((BN, C, 4), dtype=torch.float32, device=lemg.device)
    BWD_CLUSTER_SPLIT_KERNEL.launch(lemg.data_ptr(), trans.data_ptr(), beta.data_ptr(),
                                    split.data_ptr(), G, BN, K, K_real, _shape, 1.0 / K_real)
    return beta, split


def chain_floor(steps: int, threads: int, blocks: int, device, values: int = 8) -> torch.Tensor:
    """Launches `steps` dependent reductions of the sweep kernels' kind
    (`values` = 8 sums, or 16 as the nl = 3 forward steps take them:
    butterfly, one shared-memory slot per warp, one named barrier)
    with `threads` threads in each of `blocks` blocks and nothing else: timed,
    it gives the least a dependent step of a sweep can take on the card."""
    if torch.device(device).type != "cuda":
        raise ValueError("chain_floor times the card and needs a CUDA device")
    out = torch.empty((blocks,), dtype=torch.float32, device=device)
    FLOOR_KERNEL.launch(out.data_ptr(), blocks, steps, threads, values)
    return out


def cluster_floor(steps: int, chains: int, device, values: int = 8) -> torch.Tensor:
    """The same for the cluster form's read step (`values` = 8 or 12, as at
    nl = 2 or 3: the block reductions, then the cluster exchange) on `chains`
    clusters of the form's shape; out [chains * blocks a cluster]."""
    if torch.device(device).type != "cuda":
        raise ValueError("cluster_floor times the card and needs a CUDA device")
    out = torch.empty((chains * _CLUSTER_C,), dtype=torch.float32, device=device)
    CLUSTER_FLOOR_KERNEL.launch(out.data_ptr(), chains, steps, values)
    return out


def fwd_sweep_plain(lemg, beta, lem_pad, slots, first_read, lab_init, trans,
                    cnt_max, K_real, it_mode, want_alpha=True, nl=2, prior=(0.5, 0.5)):
    """Plain PyTorch version of the forward sweep (same semantics as the
    Pallas kernel _make_fwd_kernel but for the skipped slots, which leave
    alpha, pC and logc as they are, and for the label draw, which compares
    the cumulative weight with u * (sum of weights) as the CUDA kernel does
    where the Pallas kernel divides)."""
    G, BN, K = lemg.shape
    B = BN // nl
    row = lambda x, h: x[h * B:(h + 1) * B]
    f32 = torch.float32
    dev = lemg.device
    km = (torch.arange(K, device=dev) < K_real).to(f32)
    invK = 1.0 / K_real
    lemg_out = lemg.clone()
    alphas = torch.zeros((G if want_alpha else 1, BN, K), dtype=f32, device=dev)
    h_out = slots[:, 1].clone()
    u_all = slots[:, 0].contiguous().view(f32)
    skip_all = slots[:, 2] > 0
    rg_all = slots[:, 3]
    first = first_read.reshape(B, 1)
    alpha = torch.zeros((BN, K), dtype=f32, device=dev)
    logc = torch.zeros((BN, 1), dtype=f32, device=dev)
    uf = torch.zeros((B, 1), dtype=f32, device=dev)
    lab = lab_init.clone()
    counts = cnt_max.reshape(-1).tolist()
    for g in range(G):
        lg = lemg[g]
        mx = torch.where(km > 0, lg, _NEG).amax(1, keepdim=True)
        e_g = torch.exp(lg - mx) * km
        isf = 1.0 if g == 0 else 0.0
        a_raw = e_g * (trans[0, g] * alpha + (trans[1, g] + isf) * invK)
        s = a_raw.sum(1, keepdim=True)
        bad = ((~torch.isfinite(s)) | (s <= 0)).to(f32)
        for h in range(nl):
            uf = torch.maximum(uf, row(bad, h))
        s_safe = torch.where(s > 0, s, torch.ones_like(s))
        alpha = a_raw * (1.0 / s_safe)
        logc = logc + torch.log(s_safe) + mx
        bg = beta[g]
        pc = (alpha * bg).sum(1, keepdim=True)
        for i in range(counts[g]):
            lem_i = lem_pad[g, i]                           # [B, K]
            emk = torch.exp(lem_i)
            inv = torch.exp(-lem_i)
            u = u_all[g, i][:, None]
            hC = h_out[g, i][:, None]
            skip = skip_all[g, i][:, None]
            rg = rg_all[g, i][:, None]
            ab = [row(alpha, h) * row(bg, h) for h in range(nl)]
            gain = [(x * emk).sum(1, keepdim=True) for x in ab]
            lose = [(x * inv).sum(1, keepdim=True) for x in ab]
            pcs = [row(pc, h) for h in range(nl)]
            no = torch.zeros_like(skip)
            if it_mode == 0:
                doing_pass, doing_init = rg < first, rg >= first
            elif it_mode == 1:
                doing_pass, doing_init = no, rg < first
            else:
                doing_pass, doing_init = no, no
            normal = ~doing_init
            oh_C = [hC == h for h in range(nl)]
            lose_C = lose[0]
            for h in range(1, nl):
                lose_C = torch.where(oh_C[h], lose[h], lose_C)
            # candidate weights w[n] = prior[n] * prod_m term(n, m)
            # (reference: sample_reads_in_grid, gibbs-nipt.cpp:733-1341)
            w = []
            for n in range(nl):
                prod = None
                for m in range(nl):
                    if m == n:
                        t_norm = torch.where(oh_C[n], pcs[m], gain[n])
                        t_init = gain[n]
                    else:
                        t_norm = torch.where(
                            oh_C[n], pcs[m],
                            torch.where(oh_C[m], lose_C, pcs[m]),
                        )
                        t_init = pcs[m]
                    term = torch.where(doing_init, t_init, t_norm)
                    prod = term if prod is None else prod * term
                w.append(prod * float(prior[n]))
            wsum = w[0]
            for n in range(1, nl):
                wsum = wsum + w[n]
            badv = (~torch.isfinite(wsum)) | (wsum <= 0)
            uf = torch.maximum(uf, (badv & ~skip).to(f32))
            # h_new = number of candidates whose cumulative weight <= u * wsum
            # (a bad wsum never flips, whatever h_new is); a candidate of
            # prior 0 at the end is never drawn, since u < 1
            uw = u * wsum
            cum = torch.zeros_like(wsum)
            h_new = torch.zeros_like(hC)
            for n in range(nl - 1):
                cum = cum + w[n]
                h_new = h_new + (cum <= uw).to(torch.int32)
            active = (~skip) & (~doing_pass) & (~badv)
            oh_N = [h_new == h for h in range(nl)]
            flip = active & ((h_new != hC) | doing_init)
            flip_f = flip.to(f32)
            rows = []
            for h in range(nl):
                fac = torch.where(oh_N[h], emk, 1.0) * torch.where(
                    oh_C[h] & normal, inv, 1.0
                )
                a_h = alpha[h * B:(h + 1) * B] * torch.where(flip, fac, 1.0)
                d_h = (oh_N[h].to(f32) - oh_C[h].to(f32) * normal.to(f32)) * flip_f
                lemg_out[g, h * B:(h + 1) * B] += d_h * lem_i
                lab[:, h:h + 1] += (oh_N[h].to(f32) - oh_C[h].to(f32)) * flip_f
                pc_new = torch.where(
                    oh_N[h], gain[h], torch.where(oh_C[h] & normal, lose_C, pcs[h])
                )
                pc_h = torch.where(flip, pc_new, pcs[h])
                # a skipped slot changes nothing: no renormalisation (its
                # sum is 1 within rounding) and no logc term
                sh = torch.where(skip, 1.0, (a_h * km).sum(1, keepdim=True))
                sh_safe = torch.where(sh > 0, sh, torch.ones_like(sh))
                rs = 1.0 / sh_safe
                rows.append((a_h * rs, torch.log(sh_safe), pc_h * rs))
            h_out[g, i] = torch.where(flip, h_new, hC)[:, 0]
            alpha = torch.cat([r[0] for r in rows])
            logc = logc + torch.cat([r[1] for r in rows])
            pc = torch.cat([r[2] for r in rows])
        if want_alpha:
            alphas[g] = alpha
    return lemg_out, alphas, h_out, logc, uf, lab


def bwd_sweep_plain(lemg, trans, K_real):
    """Plain PyTorch version of the backward sweep (_make_bwd_kernel)."""
    G, BN, K = lemg.shape
    km = (torch.arange(K, device=lemg.device) < K_real).to(torch.float32)
    beta = torch.empty_like(lemg)
    b = torch.ones((BN, K), dtype=torch.float32, device=lemg.device)
    beta[G - 1] = b
    for g in range(G - 2, -1, -1):
        lg = lemg[g + 1]
        mx = torch.where(km > 0, lg, _NEG).amax(1, keepdim=True)
        etb = torch.exp(lg - mx) * km * b
        sm = etb.sum(1, keepdim=True)
        bn = trans[0, g + 1] * etb + trans[1, g + 1] * sm * (1.0 / K_real)
        mxb = bn.amax(1, keepdim=True)
        b = bn / torch.where(mxb > 0, mxb, torch.ones_like(mxb))
        beta[g] = b
    return beta
