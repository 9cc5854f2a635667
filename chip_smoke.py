#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (quilt_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   - compile every CUDA source of the port with nvcc (sm_90a),
               one process per source, and print the build time;
  2. kernels - run each ported kernel at the full-width shapes of the main
               paths against its plain PyTorch version, print the error and
               the median times of both (CUDA events); the Gibbs sweeps also
               in their general variant, timed in turn by chain thread count
               (64 / 128 / 256) and, backward, in the step's look-ahead form,
               beside the time of the bare dependent reduction, and the
               forward sweep at a second state with the slot occupancy of
               the world's own samples; the three Gibbs kernels again at
               NL = 3 (NIPT: 56 chains = 168 state rows, prior (0.5, 0.45,
               0.05)), timed in turn with the NL = 2 launches, the forward
               one also with a step's 9 / 12 values reduced as one reduction
               of 16 instead of two of at most 8; the share of chains whose labels
               part from the plain version's is printed and bounded; the
               dosage kernel (redesigned: a warp a (grid, chain) pair, the
               normalisation deferred) timed in turn with its previous form
               at NL = 2 and 3; the forms past the shared-memory ones: the
               cluster forms (one chain on a thread-block cluster) of the
               forward sweep at K = 10,368, 12,288 and their capacity (NL =
               2 and 3) and of the bank at 6,272 (512 grids), 8,192 and
               12,288, two launches bit for bit, timed in turn with the
               global forms they took over from (also at 512 grids) beside
               the "cluster step split" lines; the global forms past the
               cluster capacity (forward 16,512 / 12,416, bank 16,512, the
               backward at 10,368) and the dosage kernel at 30,000, all
               against their plain versions at a small G; the
               forward bank of the NIPT block move (nipt_bank, a kernel with
               no Pallas counterpart: the JAX package runs it as an XLA scan)
               at 28 chains in each of its forms, timed in turn with its
               previous form beside the floor of a step's reduction (the
               "bank step split" line); the three K-split FB
               kernels are checked at 28 rows x K=40,960 once the large
               world exists (the backward, one launch an FB call, on all
               512 grids, two launches equal bit for bit; the emission
               maxima, redesigned with byte tables, within their stated
               tolerance and timed in turn with their previous form), the forward and
               the backward are timed in turn with their previous forms (the
               forward's alpha in a global row; a remat and a backward
               launch per chunk) beside their cluster exchanges' floors (the
               "tiled forward step split" and "tiled step split" lines),
               fb_tiled_core is held against the
               fused fb_core, and both FB families are timed at 14 to 112
               rows x K=5,120, 8,192, 10,240, 20,480 and 40,960 (the
               measurements behind kernels.fb.fb_plan; 16 blocks a row
               where fb_plan weighs it); the K-split forward and backward
               at their widest blocks (check_wide_tiled: 84 rows x K =
               98,304 at 8 and 16 blocks a row, 16 rows x 194,512 x 128
               grids at 16; the staged form, 24 haplotypes a thread with its words in
               shared memory, and clusters of 16) against their plain
               versions at the first and the last, timed in turn with the
               general form, the clusters the card holds at once printed,
               with the "tiled forward step split" and "tiled step split"
               lines there;
               the fused FB backward with gamma capture (the HLA form) is
               checked at 112 and 14 rows x K=5,120 and timed in turn with
               the form without capture; the fused FB forward and backward
               (redesigned: row state in registers and shared memory, few
               reductions a step) are timed in turn with their previous form
               and, backward, the same launch with no thinned grid, beside
               the chain floor of their reductions (the "fb step split"
               line); at K=40,960 the fused backward takes its global-plane
               storage;
  3. e2e     - QUILT1 diploid imputation through the batched engine at
               full width (K=5,120 panel haplotypes, 16,384 SNPs, Ksubset
               600, 7 chains x 3 seek iterations x 21 sweeps, 8 samples at
               ~1x coverage, simulated from a seed); prints seconds,
               samples/s, r2 against truth, the share of live read slots,
               the per-stage timers and each kernel's launch count; the
               four kernels of the path must launch; one more call under
               torch.profiler gives the device-time shares (here and in
               phases 4 and 5);
  4. dist    - multiple GPUs and hosts on the one card: the segment
               kernels of the panel-sharded FB (csrc/fb_sharded.cu; the JAX
               body is XLA, quilt_tpu/kernels/fb_full.py:440: the local
               passes once a call, a fused forward and backward step a
               segment, the backward rebuilding its alphas from the
               forward's checkpoints) against their plain versions on the
               calls' own inputs at 112 rows x K = 5,120 split 2, 3 and 4
               ways and at the mesh run's 56 rows, at segments 0, 1, 31, 63
               and the capture's, two launches equal bit for bit, the
               rebuilt alphas equal to the forward's; the steps timed in
               turn with the previous form's apply and local passes at 56
               and 112 rows, beside the "seg step split" lines; fb_full_sharded
               over make_mesh(1, n, [cuda:0] x n), n = 2, 3 and 4, against
               fb_full_batched (dosage, log-likelihood, top-K at the thinned
               grids, the captured gamma at 14 rows), its time in turn with
               sharded_core's previous form, the peak memory of each and an
               exchange's time (one-card figures: the shards run in turn);
               the same at k100k's panel (84 rows x K = 98,304, 2 and 4
               shards, the kernels checked at two segments) beside the
               unsharded FB; the e2e world at mesh (2, 2) over [cuda:0] x 4
               (r2 >= 0.9, each sample's DS r2 > 0.98 against the
               single-card run, a step a segment and a local pass a call on
               each shard, the fused FB not; the peak memory of the same
               call in the previous form) and at (2, 1) (the single-card
               VCF byte for byte); the CLI world imputed by two processes on
               the card over gloo (--distributed_nproc 2) against one:
               sample columns bit for bit, INFO within 1e-3, only rank 0
               writes the VCF;
  5. quilt2  - QUILT2 diploid imputation (msPBWT selection + rare/common
               all-SNP Gibbs) of the same shape, with 10% of the sites
               rewritten to 1-4 carriers (rare); prints samples/s, r2 over
               all / common / rare sites and the per-stage timers; the Gibbs
               forward, backward and dosage kernels must launch;
  6. largek  - QUILT1 diploid imputation against a large panel (K=40,960
               haplotypes, 16,384 SNPs, 2 samples = 28 FB rows), where the
               FB plan takes the K-split kernels; the three of them must
               launch once an FB call each (6 a call), the two Gibbs sweeps
               must launch, and the fused FB must not; no path may launch
               a previous form of a redesigned kernel;
  7. bench   - the worlds that only the benchmark programs run, built and
               driven by quilt_tpu_torch/bench's functions: the FB family
               fb_plan takes at bench.fb's 2,048 grids x 28 rows (the
               K-split one) and the fused one against their plain versions,
               then bench.fb once (its JSON line); QUILT1 on the e2e
               world's panel and shape with ONT reads (make_world: 8
               samples, ~6 kb reads at phred 10; fails under r2 0.8);
               the K-split FB at K = 98,304 x 512 grids: the kernels
               fb_plan takes at 16 rows and at the K100k batch's 112 (their
               forms printed) against their plain versions on 4 rows at
               check_tiled_kernels' tolerances, two launches equal bit for
               bit, and both families timed at 16 and 112 rows; QUILT1 and
               QUILT2 against a 98,304-haplotype panel (8 samples; fails
               under r2 0.9 / 0.85; the FB plan, the msPBWT build and the
               peak device memory printed; the FB family the plan takes
               must launch, and gibbs_dos in QUILT2); fb_plan's choices at
               16 and 112 rows x K = 194,512 timed; QUILT1 against a panel
               of TOPMed r2's size (k200k: 194,512 haplotypes x 16,384
               SNPs, 4 samples; fails under r2 0.9; the plan and its forms,
               the profile and the peak memory printed); and chains 0-6 of a
               256-chain Gibbs call equal to a 7-chain call on the same
               inputs bit for bit (labels and logc); each section's
               seconds;
  8. nipt    - NIPT (mother + fetus, 3 latent haplotypes a chain) at full
               width: QUILT1-NIPT on the K=5,120 world's shape with 8 samples
               at 2x coverage, four at fetal fraction 0.10 and four at 0.20
               (two batches of 28 chains = 84 state and FB rows), then
               QUILT2-NIPT (msPBWT + rare/common) with 4 samples at 0.20;
               prints samples/s, maternal and fetal r2, the per-stage timers
               (block moves and read classes apart from the sweeps) and a
               profile; the forward and backward sweeps at NL = 3 and the
               block move's bank kernel must launch on both and the dosage
               kernel on the second; fails
               under maternal r2 0.85 or fetal r2 0.5;
  9. wide    - Gibbs at a Ksubset past the kernels' shared-memory forms: a
               panel of 10,496 haplotypes over 1,024 SNPs, 2 samples, imputed
               diploid at Ksubset 10,368 (the forward's cluster form and the
               backward's global form must launch; fails under r2 0.9) and
               NIPT at Ksubset 8,192, ff 0.2 (the forward's cluster form at
               NL = 3 and the bank's must launch; fails under maternal r2
               0.85 or fetal r2 0.5); the forward's and the bank's global
               forms must not launch on either; the sweeps and the bank
               (the block move's bank and its read-free re-run among them)
               held against their plain versions on the warm-up call's own
               inputs (_path_probe);
 10. hla     - QUILT-HLA at full width through `hla-prepare` and `hla`
               of the port's CLI (in this process): the K=5,120 /
               16,384-SNP shape with a 3,000 bp gene whose panel SNPs are
               the variant sites of 2,000 simulated alleles (each panel
               haplotype carries one, Zipf-skewed), 4 samples at 1x plus
               reads over the gene, 7 chains x 3 seek iterations x 21
               sweeps through the per-sample engine with gamma capture;
               prints seconds, samples/s, the stage times (the pair scan
               and hla-prepare among them), launches, a profile of one
               sample's engine call and the share of the 8 true alleles
               typed (combined, and from the gammas alone); the sweeps, the
               FB forward and the capturing FB backward must launch; fails
               on a sample without captured gamma or under half the
               alleles typed (combined);
 11. map     - block Gibbs at the static map boundaries
               (block_gibbs_boundary_detection="map") on a world with a hot
               genetic map (hotspots at 15x the background rate; the
               QUILT1 shape, 8 samples at ~1x), then 4 NIPT samples at ff
               0.20 on the same panel (2x); prints NB, samples/s, r2, the
               PSE beside the same world's under "gamma", the share of
               chains that took a swap, the timers, launches and a profile
               with the device time of the kernels the block move
               launched (gibbs:block_move, a host range);
               fails at NB = 0, with no swap taken, under r2 0.9 (NIPT:
               maternal 0.85, fetal 0.5), or when a kernel of the path
               (the Gibbs sweeps, the fused FB, NIPT's bank) never launched;
 12. diag    - the FB kernels that fb_plan takes at the path's 14 and 2
               rows against their plain versions; then
               the nine per-sample diagnostic options at once, 2 QUILT1
               samples of the map world (its panel given msPBWT indices, so
               the heuristic comparison reruns each sample under both
               msPBWT approaches) through the per-sample engine with truth;
               fails unless the npz holds every <object>_<sample> key, the
               plots' data files exist, the VCF declares OHD, every OHD
               value is finite and OHD r2 against truth is >= 0.9, or when
               the Gibbs sweeps, the Gibbs dosages (the seek dosages) or an
               FB family (the K-split one at these rows) did not launch;
 13. cli     - small file-based `prepare` + `impute`, `prepare2` +
               `impute2` and `impute --method nipt --fflist` runs through
               the port's CLI, and a one-sample `impute` that must go
               through the per-sample engine; checks the VCFs.
Each phase prints its seconds. The port must run without the JAX package:
the script fails if `jax` or `quilt_tpu` is loaded after the port's
modules are imported.
The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20240611
# published H100 SXM peaks: HBM3 bytes/s and float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# a uniform within rounding of a candidate boundary may draw the other label
# in the kernel than in the plain version, and that chain then parts for the
# rest of the sweep; more than this share of the chains parting is a fault
PARTED_CHAINS_BOUND = 0.1
# r2 bounds of the benchmark's ONT world (fast_packed_panel, ~6 kb reads at
# 1x): its r2 sits near 0.75 in both engines, since at 1x the gaps between
# a haplotype's long reads outlast the truth's copying segments and no site
# of that panel is easy (tests/test_torch_ont_bench.py); the card's
# readings were min 0.686 / mean 0.743 (8 samples) and 0.694 / 0.769 (32)
ONT_BENCH_R2_MIN, ONT_BENCH_R2_MEAN = 0.65, 0.70
# samples of the k200k world (bench phase): 4, half of k100k's 8, so that
# the whole run stays near its length before the world came (649.5 s of
# phases on an H100; with 8 it took 841.3 s, PERF.md)
K200K_SAMPLES = 4


# ptxas's report of the redesigned kernels' instantiations, filled by the build
PTXAS = {}
# kernel -> the names of its template arguments in the ptxas notes
_PTXAS_KERNELS = {"fb_bwd_tiled_kernel": ("CPT", "shared"), "fb_fwd_tiled_kernel": ("CPT",),
                  "nipt_bank_kernel": ("CPT",), "nipt_bank_general_kernel": ("GLOBAL",),
                  "fb_max_tiled_kernel": (), "gibbs_dos_kernel": ("NL", "VEC"),
                  "gibbs_fwd_global_kernel": ("NL",), "gibbs_bwd_global_kernel": (),
                  "gibbs_fwd_cluster_kernel": ("NT", "CPT", "NL"),
                  "gibbs_bwd_cluster_kernel": ("NT", "CPT", "SPLIT"),
                  "nipt_bank_cluster_kernel": ("CPT",), "seg_fwd_local_kernel": (),
                  "seg_fwd_step_kernel": (), "seg_bwd_local_kernel": (),
                  "seg_bwd_step_kernel": (), "seg_fwd_apply_kernel": (),
                  "seg_bwd_apply_kernel": ()}


def _note_ptxas(library, entry, line):
    """Keeps the registers and spills that ptxas reports for each
    instantiation of the kernels of _PTXAS_KERNELS (not their previous
    forms, but for the sharded FB's apply passes, which the seg step split
    reads)."""
    import re

    if entry is None or library not in ("fb_tiled", "nipt_bank", "gibbs_sweep", "gibbs_dosage",
                                        "fb_sharded"):
        return
    m = re.search(r"\d+(" + "|".join(_PTXAS_KERNELS) + r")(I((?:L[a-z]+\d+E)+)E)?", entry)
    if m is None:
        return
    args = re.findall(r"L[a-z]+(\d+)E", m.group(3) or "")
    tag = "<" + ", ".join(f"{n}={a}" for n, a in zip(_PTXAS_KERNELS[m.group(1)], args)) + ">"
    notes = PTXAS.setdefault(m.group(1), [])
    if "spill" in line:
        st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line).groups()
        notes.append(f"{tag} spills {st}/{ld} B")
    else:
        regs = re.search(r"Used (\d+) registers", line).group(1)
        notes[-1] += f", {regs} registers"


def _fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def _median_ms(fn, n):
    import torch

    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _timed(fn):
    """(fn(), its ms on the card): a plain version's reference run, timed
    with CUDA events, is its timing where it takes seconds; a shorter one is
    timed again after it (median of 2), so that no first call's set-up
    enters the time."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    return out, ms if ms >= 2000 else _median_ms(fn, 2)


def _alternating_ms(fns, rounds=4, n=7):
    """{name: median ms} of the functions timed in turn, `rounds` times round
    (every other round in reverse order), the median of n launches each time:
    the card's clock drifts within a call, and variants timed one after the
    other would carry the drift."""
    times = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else reversed(list(fns))):
            times[name].append(_median_ms(fns[name], n))
    return {name: statistics.median(t) for name, t in times.items()}


# How _device_ms times: "profiler" until torch.profiler has recorded no
# device-side event in PROFILER_TRIES windows in a row (the tracer can
# come back empty on a card it traced before), "queued events" from then on.
DEVICE_TIMER = ["profiler"]
PROFILER_TRIES = 3
QUEUE_SLEEP_CYCLES = 20_000_000     # ~10 ms at the H100's 1.98 GHz


def _profiled_ms(fn, n):
    """ms of device time a call of fn: the device-side events of a
    torch.profiler window around n calls, summed, over n; None where the
    window recorded no device-side event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    us = sum(dev_us(e) for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return us / 1e3 / n if us else None


def _queued_ms(fn, n):
    """ms of device time a call of fn from CUDA events around n calls that
    the host queues while torch.cuda._sleep holds the stream: the events
    span the device's work on the n calls, not the wrappers' host side."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _device_ms(fn, n):
    """ms of device time a call of fn (DEVICE_TIMER says how it was taken).
    For kernels of tens of microseconds, whose wrappers' host side (the
    argument checks, the allocation) outlasts them, CUDA events around a
    call time the host."""
    if DEVICE_TIMER[0] == "profiler":
        for _ in range(PROFILER_TRIES):
            ms = _profiled_ms(fn, n)
            if ms is not None:
                return ms
        DEVICE_TIMER[0] = "queued events"
        print(f"chip_smoke: torch.profiler recorded no device time in {PROFILER_TRIES} windows "
              f"in a row; kernel device times from here on are CUDA events around queued "
              f"launches behind torch.cuda._sleep", flush=True)
    return _queued_ms(fn, n)


def _alternating_device_ms(fns, rounds=4, n=10):
    """_alternating_ms with _device_ms: {name: median device ms a call},
    all taken the same way (timed again if the timer changed on the way)."""
    timer = DEVICE_TIMER[0]
    times = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else reversed(list(fns))):
            times[name].append(_device_ms(fns[name], n))
    if DEVICE_TIMER[0] != timer:
        return _alternating_device_ms(fns, rounds, n)
    return {name: statistics.median(t) for name, t in times.items()}


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _real_bytes(t, K_real):
    """Bytes of a [..., K] tensor's first K_real columns: the real
    haplotypes, all that a function masking the pads needs of it."""
    return t.numel() // t.shape[-1] * K_real * t.element_size()


def _fwd_work(args, outs, K_real):
    """(bytes, operations) of a forward sweep on this state, as the function
    needs them: beta and, of lem_pad, only the rows of live slots (a skipped
    slot is no step) at the K_real real haplotypes; lemg whole (lemg' carries
    its pad columns); every other tensor read or written once in full.
    Operations: per (grid, state row, real haplotype) ~8 for the emission
    and alpha step, and per live read slot, latent row and real haplotype
    ~6 for the relabelling."""
    lemg, beta, lem_pad = args[0], args[1], args[2]
    G, BN, _ = lemg.shape
    nl = BN // lem_pad.shape[2]
    n_live = int((args[3][:, 2] == 0).sum())
    others = [t for i, t in enumerate(args) if i not in (1, 2)]
    return (_nbytes(*others, *outs) + _real_bytes(beta, K_real)
            + n_live * K_real * lem_pad.element_size(),
            8 * G * BN * K_real + 6 * nl * n_live * K_real)


def _bwd_work(lemg, trans, beta, K_real):
    """(bytes, operations) of a backward sweep: lemg at the real haplotypes
    (the pads are masked), trans, beta written whole (its pads hold the jump
    term); ~8 operations a (grid, state row, real haplotype)."""
    G, BN, _ = lemg.shape
    return (_real_bytes(lemg, K_real) + _nbytes(trans, beta), 8 * G * BN * K_real)


def _dos_work(alphas, beta, words_T, hd, K_real):
    """(bytes, operations) of a dosage sweep: alphas, beta and the words at
    the real haplotypes only (the pads are masked), hd written whole; ~34
    operations a (grid, state row, real haplotype)."""
    G, BN, _ = alphas.shape
    return (sum(_real_bytes(t, K_real) for t in (alphas, beta, words_T)) + _nbytes(hd),
            (32 + 2) * G * BN * K_real)


def _bound(nbytes, flops):
    """(ms, "bytes" | "operations"): the least time the card could take, the
    larger of the bytes the function must move (each input read once, each
    output written once) over the HBM rate and its float32 operations over
    the float32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"


def _row(name, source, replaces, err, ms, plain_ms, nbytes, flops):
    """One row of the kernels line. No single PyTorch call computes any of
    these functions, so library_ms is null."""
    bound_ms, bound_by = _bound(nbytes, flops)
    return dict(name=name, route="cuda", source=f"quilt_tpu_torch/csrc/{source}",
                replaces=f"quilt_tpu/kernels/{replaces}", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions at full-width shapes
# ---------------------------------------------------------------------------

def _check_fwd(label, got, ref, args, alphas=True):
    """A forward sweep's outputs against the plain version's (the alphas
    only where the sweep was asked for them); returns (got, the larger of
    the lemg and logc errors)."""
    import torch

    torch.cuda.synchronize()
    live = args[3][:, 2] == 0
    B = live.shape[2]
    nl = args[0].shape[1] // B
    agree = (got[2][live] == ref[2][live]).float().mean().item()
    # a uniform within rounding of a candidate boundary may draw the other
    # label and fork that chain; compare state only on rows that agree
    same = ((got[2] == ref[2]) | ~live).all(dim=0).all(dim=0)          # [B]
    rows2 = torch.cat([same] * nl)
    err_lemg = (got[0] - ref[0]).abs()[:, rows2].max().item()
    err_logc = (got[3] - ref[3]).abs()[rows2].max().item()
    ok = (agree > 0.995 and torch.equal(got[2][~live], ref[2][~live])
          and torch.allclose(got[0][:, rows2], ref[0][:, rows2], rtol=1e-4, atol=1e-3)
          and (not alphas or torch.allclose(got[1][:, rows2], ref[1][:, rows2], rtol=1e-4, atol=1e-6))
          and torch.allclose(got[3][rows2], ref[3][rows2], rtol=1e-4, atol=1e-3)
          and torch.equal(got[4], ref[4]) and torch.equal(got[5][same], ref[5][same]))
    parted = 1.0 - int(same.sum()) / B
    print(f"{label}: labels agree {agree:.6f}, {int(same.sum())}/{B} chains identical "
          f"({100 * parted:.1f}% part, bound {100 * PARTED_CHAINS_BOUND:.0f}%), "
          f"max |lemg err| {err_lemg:.3e}, max |logc err| {err_logc:.3e} "
          f"(tolerance: labels > 0.995, rtol 1e-4 / atol 1e-3)", flush=True)
    if not ok:
        _fail(f"{label} disagrees with its plain version")
    if parted > PARTED_CHAINS_BOUND:
        _fail(f"{label}: {100 * parted:.1f}% of the chains part from the plain version")
    return got, max(err_lemg, err_logc)


def check_kernels(world):
    """Each ported kernel vs its plain version on the card; returns the
    rows of the kernels line (launch counts filled in after the e2e)."""
    import numpy as np
    import torch
    from quilt_tpu_torch.kernels import fb as fbk
    from quilt_tpu_torch.kernels import gibbs_sweep as gs
    from quilt_tpu_torch.simulate import random_sweep_state

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rows = []

    # Gibbs sweeps at the e2e shape: G=512, B=8 samples x 7 chains, K=640
    G, B, K, K_real = world["nGrids"], 56, 640, 600
    W = max(world["max_reads_per_grid"], 1)
    args = [torch.from_numpy(x).cuda() for x in random_sweep_state(
        np.random.default_rng(SEED), G, B, W, K, K_real, W)]
    kw = dict(nl=2, K_real=K_real, it_mode=2, prior=(0.5, 0.5))
    ref, plain_ms = _timed(lambda: gs.fwd_sweep_plain(*args, K_real=K_real, it_mode=2))
    got, err = _check_fwd("gibbs_fwd", gs.fwd_sweep(*args, **kw), ref, args)
    # the general variant (state in local arrays) takes any K; same check
    _check_fwd("gibbs_fwd, general variant", gs.fwd_sweep(*args, _variant=-1, **kw), ref, args)
    live = args[3][:, 2] == 0

    lemg = got[0]
    trans = args[6]
    ref_b, plain_b = _timed(lambda: gs.bwd_sweep_plain(lemg, trans, K_real))
    for label, bkw in (("gibbs_bwd, general variant", dict(_variant=-1)),
                       ("gibbs_bwd, look-ahead form", dict(_variant=128, _ahead=True)),
                       ("gibbs_bwd", {})):
        got_b = gs.bwd_sweep(lemg, trans, nl=2, K_real=K_real, **bkw)
        err_b = (got_b - ref_b).abs().max().item()
        print(f"{label}: max |beta err| {err_b:.3e} (tolerance rtol 1e-5, atol 1e-6)", flush=True)
        if not torch.allclose(got_b, ref_b, rtol=1e-5, atol=1e-6):
            _fail(f"{label} disagrees with its plain version")

    # the kernels as the engine launches them (default) beside the chain
    # variants (64 / 128 / 256 chain threads with the state in registers, the
    # general one, and the backward step's look-ahead form), timed in turn
    variants = (("default", None), ("64", 64), ("128", 128), ("256", 256), ("general", -1))
    bwd = lambda **v: (lambda: gs.bwd_sweep(lemg, trans, nl=2, K_real=K_real, **v))
    t_fwd = _alternating_ms({n: (lambda t=t: gs.fwd_sweep(*args, _variant=t, **kw))
                             for n, t in variants})
    t_bwd = _alternating_ms({**{n: bwd(_variant=t) for n, t in variants},
                             "128 look-ahead": bwd(_variant=128, _ahead=True)})
    fmt = lambda d: ", ".join(f"{k} {v:.3f} ms" for k, v in d.items())
    print(f"gibbs_fwd by chain threads (K={K}, timed in turn): {fmt(t_fwd)}", flush=True)
    print(f"gibbs_bwd by chain threads (K={K}, timed in turn): {fmt(t_bwd)}", flush=True)
    rows.append(_row("gibbs_fwd", "gibbs_sweep.cu", "gibbs_pallas.py:56",
                     err, t_fwd["default"], plain_ms, *_fwd_work(args, got, K_real)))
    rows.append(_row("gibbs_bwd", "gibbs_sweep.cu", "gibbs_pallas.py:351", err_b,
                     t_bwd["default"], plain_b, *_bwd_work(lemg, trans, got_b, K_real)))

    # the least a dependent step can take
    steps = 20000
    floor_ns = {t: _median_ms(lambda: gs.chain_floor(steps, t, B, "cuda"), 3) * 1e6 / steps
                for t in (64, 128, 256)}
    live_b = live.sum(dim=(0, 1))                                        # [B]
    fwd_steps = G + int(live_b.max())
    print("chain floor (one 8-value reduction: butterfly, shared-memory slot per warp, named "
          "barrier): " + ", ".join(f"{t} threads {v:.1f} ns" for t, v in floor_ns.items())
          + f"; gibbs_fwd walks {fwd_steps} dependent steps on its longest chain (mean "
          f"{G + live_b.float().mean().item():.0f}) = {fwd_steps * floor_ns[128] / 1e6:.3f} ms at "
          f"128 threads, gibbs_bwd {G - 1} = {(G - 1) * floor_ns[128] / 1e6:.3f} ms", flush=True)

    # gibbs_fwd again with the slot occupancy of the world's own samples:
    # chain b carries the reads per grid of sample b // 7 (7 chains a sample)
    per_sample = np.stack([np.bincount(r.wif0, minlength=G)[:G] for r in world["samples"]], 1)
    counts = np.repeat(per_sample, B // per_sample.shape[1], axis=1)     # [G, B]
    args_w = [torch.from_numpy(x).cuda() for x in random_sweep_state(
        np.random.default_rng(SEED + 3), G, B, W, K, K_real, W, counts=counts)]
    ref_w = gs.fwd_sweep_plain(*args_w, K_real=K_real, it_mode=2)
    got_w, _ = _check_fwd("gibbs_fwd, world occupancy", gs.fwd_sweep(*args_w, **kw), ref_w, args_w)
    live_w = args_w[3][:, 2] == 0
    walked = int(args_w[7].sum()) * B
    ms_w = _median_ms(lambda: gs.fwd_sweep(*args_w, **kw), 5)
    bound_w, by_w = _bound(*_fwd_work(args_w, got_w, K_real))
    print(f"gibbs_fwd, world occupancy: {ms_w:.3f} ms, bound {bound_w:.4f} ms ({by_w}); "
          f"{int(live_w.sum())} live of {walked} slots "
          f"under the per-grid maximum ({100 * int(live_w.sum()) / max(walked, 1):.1f}% live; "
          f"{G + int(live_w.sum(dim=(0, 1)).max())} steps on the longest chain); table shape: "
          f"{100 * int(live.sum()) / (int(args[7].sum()) * B):.1f}% live", flush=True)

    # Gibbs dosages at the same shape: the sweep's alphas and beta, and
    # random packed subset words [G, B, K] (pad columns >= K_real masked)
    alphas, beta_d = got[1], got_b
    words_T = torch.randint(-2**31, 2**31 - 1, (G, B, K), generator=gen, device="cuda",
                            dtype=torch.int64).to(torch.int32)
    eps = 0.001
    rows.append(check_dosage(2, alphas, beta_d, words_T, K_real, eps))

    rows += check_kernels_nl3(G, B, W, K, K_real, kw, args, lemg, trans, words_T)
    rows.append(check_nipt_bank(G, K, K_real))

    # full-panel FB at the e2e shape: B = 56 chains x 2 latent haps
    fb = world["fb"]
    dev = fb.device_tensors("cuda")
    words, trans2, thin = dev["words"], dev["trans2"], dev["thin_flag"]
    Bf = 112
    gl = 0.05 + 0.95 * torch.rand((Bf, 2, fb.S), generator=gen, device="cuda")
    t0 = gl[:, 0] * (1 - eps) + gl[:, 1] * eps
    t1 = gl[:, 0] * eps + gl[:, 1] * (1 - eps)
    dl = (torch.log(t1) - torch.log(t0)).contiguous()
    CG = fbk.fused_cg(fb.K_pad, fb.nGrids)
    K_top = 8
    smem, cpt = fbk._bwd_storage(CG, fb.K_pad, K_top)
    print(f"fb kernels at {Bf} rows x K={fb.K} x {fb.nGrids} grids: checkpoint interval {CG}, "
          f"the chunk's alphas in {'shared' if smem else 'global'} memory, {cpt} haplotypes a "
          f"thread in registers", flush=True)
    ck, lg, d, tv, ti, err_ck, err_d = _check_fused(dl, words, trans2, thin, fb.K, K_top, eps)

    # the redesigned kernels timed in turn with their previous form (its own
    # checkpoints, every 16 grids) and the backward on the same inputs
    # without a thinned grid (the top-K's share)
    ck16 = fbk.fb_forward(dl, words, trans2, fb.K, 16, _prev=True)[0]
    no_thin = torch.full_like(thin, -1)
    fwd = lambda *a, **v: (lambda: fbk.fb_forward(dl, words, trans2, fb.K, *a, **v))
    bwd = lambda c, th, *a, **v: (lambda: fbk.fb_backward(dl, words, c, trans2, th, fb.K, K_top,
                                                          eps, *a, **v))
    t_fwd = _alternating_ms({"new": fwd(), "previous form": fwd(16, _prev=True)})
    t_bwd = _alternating_ms({"new": bwd(ck, thin), "no thinned grid": bwd(ck, no_thin),
                             "general form": bwd(ck, thin, _general=True),
                             "previous form": bwd(ck16, thin, 16, _prev=True)})
    fmt = lambda d: ", ".join(f"{k} {v:.3f} ms" for k, v in d.items())
    print(f"fb_fwd, timed in turn: {fmt(t_fwd)}", flush=True)
    print(f"fb_bwd, timed in turn: {fmt(t_bwd)}", flush=True)
    steps = 20000
    floor_ns = [_median_ms(lambda: fbk.chain_floor(steps, Bf, w, "cuda"), 3) * 1e6 / steps
                for w in (0, 1)]
    G = fb.nGrids
    n_thin = int((thin >= 0).sum())
    prev_f, prev_b = t_fwd["previous form"], t_bwd["previous form"]
    print(f"fb step split at {Bf} rows (this run): fb_fwd {1e3 * t_fwd['new'] / G:.2f} us a grid "
          f"step (previous form {1e3 * prev_f / G:.2f}), chain floor {floor_ns[0] / 1e3:.2f} us "
          f"(one (m, s) reduction of 512 threads) = {G * floor_ns[0] / 1e6:.3f} ms a launch; fb_bwd "
          f"{1e3 * t_bwd['new'] / G:.2f} us a grid (remat + reverse step; previous form "
          f"{1e3 * prev_b / G:.2f}), of it top-K at the {n_thin} thinned grids "
          f"{t_bwd['new'] - t_bwd['no thinned grid']:.3f} ms "
          f"({100 * (1 - t_bwd['no thinned grid'] / t_bwd['new']):.1f}%), chain floor "
          f"{(floor_ns[0] + floor_ns[1]) / 1e3:.2f} us (the remat's (m, s), then a (sum, max) "
          f"and a 33-value reduction; {floor_ns[1] / 1e3:.2f} us the reverse step's two) = "
          f"{G * (floor_ns[0] + floor_ns[1]) / 1e6:.3f} ms a launch", flush=True)
    # operations per (row, grid, haplotype): 32 for the emission sum, ~8 for
    # the alpha step and its normalisation; the backward adds 32 for the
    # dosage and ~12 for beta and gamma to the remat's 40
    cells = Bf * fb.nGrids * fb.K
    rows.append(_row("fb_fwd", "fb.cu", "fb_pallas.py:106", err_ck, t_fwd["new"],
                     _median_ms(lambda: fbk.fb_forward_plain(dl, words, trans2, fb.K), 2),
                     _nbytes(dl, words, trans2, ck, lg), 40 * cells))
    rows.append(_row("fb_bwd", "fb.cu", "fb_pallas.py:151", err_d, t_bwd["new"],
                     _median_ms(lambda: fbk.fb_backward_plain(dl, words, ck, trans2, thin, fb.K, K_top, eps), 2),
                     _nbytes(dl, words, ck, trans2, thin, d, tv, ti), 84 * cells))
    rows.append(check_fb_capture(fb, dl, ck, ck16, K_top, eps))
    _print_rows(rows)
    return rows


def _check_fused(dl, words, trans2, thin, K, K_top, eps, where=""):
    """fb_forward and fb_backward against their plain versions on dl [B, S]:
    checkpoints atol 1e-5, loglik rtol 1e-5 + atol 1e-2, dosage and top-K
    values atol 1e-4, top-K indices equal where the plain values differ by
    more than 1e-3. Returns (ck, lg, dosage, top-K values, top-K indices,
    max checkpoint error, max dosage error)."""
    import torch
    from quilt_tpu_torch.kernels import fb as fbk

    ck, lg = fbk.fb_forward(dl, words, trans2, K)
    ck_r, lg_r = fbk.fb_forward_plain(dl, words, trans2, K)
    err_ck = (ck - ck_r).abs().max().item()
    err_lg = (lg - lg_r).abs().max().item()
    print(f"fb_fwd{where}: max |alpha ckpt err| {err_ck:.3e}, max |loglik err| {err_lg:.3e} "
          f"(|loglik| up to {lg_r.abs().max().item():.1f}; tolerance ckpt atol 1e-5, "
          f"loglik rtol 1e-5 + atol 1e-2)", flush=True)
    if err_ck > 1e-5 or not torch.allclose(lg, lg_r, rtol=1e-5, atol=1e-2):
        _fail(f"fb_fwd{where} disagrees with its plain version")

    d, tv, ti = fbk.fb_backward(dl, words, ck, trans2, thin, K, K_top, eps)
    d_r, tv_r, ti_r = fbk.fb_backward_plain(dl, words, ck, trans2, thin, K, K_top, eps)
    err_d = (d - d_r).abs().max().item()
    err_tv, idx_ok, n_firm = _topk_agree(tv, ti, tv_r, ti_r, thin)
    print(f"fb_bwd{where}: max |dosage err| {err_d:.3e}, max |top-K value err| {err_tv:.3e}, "
          f"top-K indices equal where the values settle them: {idx_ok} ({n_firm} places) "
          f"(tolerance dosage / top-K atol 1e-4)", flush=True)
    if err_d > 1e-4 or err_tv > 1e-4 or not idx_ok:
        _fail(f"fb_bwd{where} disagrees with its plain version")
    return ck, lg, d, tv, ti, err_ck, err_d


def _check_tiled(dl, words, trans2, thin, K, kt, K_top, eps, where="", timer=_timed):
    """The three K-split FB kernels against their plain versions on dl
    [B, S] at kt haplotypes a block, on all the grids: fb_max_tiled within
    max_tiled_tolerance (the kernel adds a logit's log-ratios by byte
    tables, the plain version by nibbles in order); the forward's
    checkpoints and S rtol 1e-5, its loglik rtol 1e-5 + atol 1e-2; the
    backward's dosage and top-K values atol 1e-4, its top-K indices equal
    where the plain values differ by more than 1e-3, zeros away from the
    thinned grids, two launches equal bit for bit. timer(fn) gives (fn(),
    its ms) for each plain version's reference run. Returns a dict of the
    kernels' and plain versions' outputs, the errors and the plain
    versions' ms."""
    import torch
    from quilt_tpu_torch.kernels import fb as fbk

    Gp = words.shape[0]
    r = {}
    r["mx_r"], r["max_plain_ms"] = timer(lambda: fbk.fb_max_tiled_plain(dl, words, K, kt))
    mx = r["mx"] = fbk.fb_max_tiled(dl, words, K, kt)
    r["err_max"] = (mx - r["mx_r"]).abs().max().item()
    tol = fbk.max_tiled_tolerance(dl, Gp)
    print(f"fb_max_tiled{where}: max |mx err| {r['err_max']:.3e} (tolerance max_tiled_tolerance, "
          f"here {tol.min().item():.2e}-{tol.max().item():.2e}; logits up to "
          f"{r['mx_r'].abs().max().item():.1f})", flush=True)
    if not ((mx - r["mx_r"]).abs() <= tol).all():
        _fail(f"fb_max_tiled{where} disagrees with its plain version")

    ck, S, lg = r["fwd"] = fbk.fb_forward_tiled(dl, words, trans2, mx, K, kt)
    (ck_r, S_r, lg_r), r["fwd_plain_ms"] = timer(
        lambda: fbk.fb_forward_tiled_plain(dl, words, trans2, mx, K, kt))
    ok = (torch.allclose(ck, ck_r, rtol=1e-5, atol=1e-30) and torch.allclose(S, S_r, rtol=1e-5, atol=0)
          and torch.allclose(lg, lg_r, rtol=1e-5, atol=1e-2))
    r["err_ck"] = (ck - ck_r).abs().max().item()
    rel_ck = ((ck - ck_r).abs() / ck_r.abs().clamp(min=1e-30)).max().item()
    rel_S = ((S - S_r).abs() / S_r).max().item()
    err_lg = (lg - lg_r).abs().max().item()
    print(f"fb_fwd_tiled{where}: max rel ckpt err {rel_ck:.3e}, max rel S err {rel_S:.3e}, max "
          f"|loglik err| {err_lg:.3e} (|loglik| up to {lg_r.abs().max().item():.1f}; tolerance "
          f"ckpt / S rtol 1e-5, loglik rtol 1e-5 + atol 1e-2)", flush=True)
    if not ok:
        _fail(f"fb_fwd_tiled{where} disagrees with its plain version")

    bargs = (dl, words, ck, trans2, thin, mx, S, K, K_top, eps, kt)
    got = r["bwd"] = fbk.fb_backward_tiled(*bargs)
    again = fbk.fb_backward_tiled(*bargs)
    ref, r["bwd_plain_ms"] = timer(lambda: fbk.fb_backward_tiled_plain(*bargs))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    r["err_d"] = (got[0] - ref[0]).abs().max().item()
    err_tv, idx_ok, n_firm = _topk_agree(got[1], got[2], ref[1], ref[2], thin)
    zeros = not got[1][thin < 0].any() and not got[2][thin < 0].any()
    print(f"fb_bwd_tiled{where} ({int((thin >= 0).sum())} thinned grids): max |dosage err| "
          f"{r['err_d']:.3e}, max |top-K value err| {err_tv:.3e}, indices equal where the values settle them: "
          f"{idx_ok} ({n_firm} places), zeros away from thinned grids: {zeros}, two launches "
          f"equal bit for bit: {same} (tolerance dosage / top-K atol 1e-4)", flush=True)
    if r["err_d"] > 1e-4 or err_tv > 1e-4 or not idx_ok or not zeros or not same:
        _fail(f"fb_bwd_tiled{where} disagrees with its plain version")
    return r


def check_fb_at_rows(fb, rows_list, K_top=8, eps=0.001):
    """The FB kernels that fb_plan takes at each of rows_list rows on fb's
    panel (the K-split family at its splits, or the fused one) against
    their plain versions, on random genotype likelihoods, at the
    tolerances of the main checks (_check_tiled, _check_fused); the plain
    versions untimed."""
    import torch
    from quilt_tpu_torch.kernels import fb as fbk

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    dev = fb.device_tensors("cuda")
    words, trans2, thin = dev["words"], dev["trans2"], dev["thin_flag"]
    for B in rows_list:
        family, per_call, splits = fbk.fb_plan(B, fb)
        dl = _random_dl(fb, B, gen, eps)[1]
        where = f" at {B} rows x K={fb.K}"
        print(f"FB{where}: fb_plan -> {family}, {per_call} rows per call, {splits} blocks per "
              f"row" + (f"; {tiled_forms(fb.K_pad, splits, fb.nGrids)}" if family == "tiled"
                        else ""), flush=True)
        if family == "tiled":
            _check_tiled(dl, words, trans2, thin, fb.K, fb.K_pad // splits, K_top, eps, where,
                         timer=lambda fn: (fn(), None))
        else:
            _check_fused(dl, words, trans2, thin, fb.K, K_top, eps, where)


def check_fb_capture(fb, dl, ck, ck16, K_top, eps):
    """fb_backward with gamma capture (the HLA run's form) against its plain
    version at 112 rows and at the HLA path's 14 rows (one sample: 7 chains
    x 2) x K = 5,120, the capture at the middle grid: gcap atol 1e-5, and
    the dosage / top-K outputs equal those of the launch without capture;
    timed in turn with the launch without capture and with the previous form's
    capture (ck16: its checkpoints). Returns the row of the capturing launch
    at 14 rows."""
    import dataclasses

    import torch
    from quilt_tpu_torch.kernels import fb as fbk

    fbc = dataclasses.replace(fb, capture_grid=fb.nGrids // 2)
    dev = fbc.device_tensors("cuda")
    words, trans2, thin, cap = dev["words"], dev["trans2"], dev["thin_flag"], dev["capture_flag"]
    row = None
    for B in (112, 14):
        dl_b, ck_b, ck16_b = dl[:B].contiguous(), ck[:, :B].contiguous(), ck16[:, :B].contiguous()
        args = (dl_b, words, ck_b, trans2, thin, fb.K, K_top, eps)
        got = fbk.fb_backward(*args, cap=cap)
        ref = fbk.fb_backward_plain(*args, cap=cap)
        plain_form = fbk.fb_backward(*args)
        torch.cuda.synchronize()
        err = (got[3] - ref[3]).abs().max().item()
        same = all(torch.equal(a, b) for a, b in zip(got[:3], plain_form))
        sums = got[3].sum(1)
        print(f"fb_bwd with capture, {B} rows x K={fb.K}: max |gcap err| {err:.3e} (tolerance "
              f"atol 1e-5), row sums {sums.min().item():.6f}-{sums.max().item():.6f}, dosage and "
              f"top-K equal to the launch without capture: {same}", flush=True)
        if not err <= 1e-5 or not same or (got[3][:, fb.K:] != 0).any():
            _fail("fb_bwd with capture disagrees with its plain version")
        args16 = (dl_b, words, ck16_b, trans2, thin, fb.K, K_top, eps, 16)
        prev = lambda: fbk.fb_backward(*args16, cap=cap, _prev=True)
        t = _alternating_ms({"capture": lambda: fbk.fb_backward(*args, cap=cap),
                             "no capture": lambda: fbk.fb_backward(*args),
                             "previous form, capture": prev})
        print(f"fb_bwd at {B} rows, timed in turn: with capture {t['capture']:.3f} ms, without "
              f"{t['no capture']:.3f} ms, the previous form with capture {t['previous form, capture']:.3f} ms",
              flush=True)
        row = _row("fb_bwd_capture", "fb.cu", "fb_pallas.py:151", err, t["capture"],
                   _median_ms(lambda: fbk.fb_backward_plain(*args, cap=cap), 1),
                   _nbytes(dl_b, words, ck_b, trans2, thin, cap, *got), 84 * B * fb.nGrids * fb.K)
    return row


def check_kernels_nl3(G, B, W, K, K_real, kw2, args2, lemg2, trans, words_T):
    """The three Gibbs kernels at NL = 3 (NIPT) against their plain versions
    at the table shape (B chains = 3B state rows, prior (0.5, 0.45, 0.05)),
    the sweeps timed in turn with the NL = 2 launches on the NL = 2 state
    (the dosage kernel in turn with its previous form, check_dosage).
    Returns the three rows (gibbs_fwd_nl3, gibbs_bwd_nl3, gibbs_dos_nl3)."""
    import numpy as np
    import torch
    from quilt_tpu_torch.kernels import gibbs_sweep as gs
    from quilt_tpu_torch.simulate import random_sweep_state

    prior = (0.5, 0.45, 0.05)
    args = [torch.from_numpy(x).cuda() for x in random_sweep_state(
        np.random.default_rng(SEED + 5), G, B, W, K, K_real, W, nl=3)]
    kw = dict(nl=3, K_real=K_real, it_mode=2, prior=prior)
    ref, plain_ms = _timed(lambda: gs.fwd_sweep_plain(*args, K_real=K_real, it_mode=2, nl=3,
                                                      prior=prior))
    got, err = _check_fwd("gibbs_fwd_nl3", gs.fwd_sweep(*args, **kw), ref, args)
    for label, v in (("general variant", dict(_variant=-1)), ("256 threads", dict(_variant=256)),
                     ("one reduction of 16", dict(_wide=True))):
        _check_fwd(f"gibbs_fwd_nl3, {label}", gs.fwd_sweep(*args, **v, **kw), ref, args)
    drawn = got[2][args[3][:, 2] == 0]
    print(f"gibbs_fwd_nl3: labels drawn 0 / 1 / 2: "
          f"{[int((drawn == h).sum()) for h in range(3)]}", flush=True)
    # fetal fraction 0: the third label has prior 0 and is never drawn
    got0 = gs.fwd_sweep(*args, nl=3, K_real=K_real, it_mode=0, prior=(0.5, 0.5, 0.0))
    torch.cuda.synchronize()
    changed = got0[2] != args[3][:, 1]
    if not changed.any() or bool((got0[2][changed] == 2).any()):
        _fail("gibbs_fwd_nl3 drew the label of prior 0 (or drew nothing)")

    lemg = got[0]
    ref_b, plain_b = _timed(lambda: gs.bwd_sweep_plain(lemg, trans, K_real))
    got_b = gs.bwd_sweep(lemg, trans, nl=3, K_real=K_real)
    err_b = (got_b - ref_b).abs().max().item()
    print(f"gibbs_bwd_nl3 ({lemg.shape[1]} state rows): max |beta err| {err_b:.3e} "
          f"(tolerance rtol 1e-5, atol 1e-6)", flush=True)
    if not torch.allclose(got_b, ref_b, rtol=1e-5, atol=1e-6):
        _fail("gibbs_bwd_nl3 disagrees with its plain version")

    fwd3 = lambda **v: (lambda: gs.fwd_sweep(*args, **v, **kw))
    t_fwd = _alternating_ms({
        "nl2": lambda: gs.fwd_sweep(*args2, **kw2), "nl3": fwd3(),
        "nl3 one reduction of 16": fwd3(_wide=True), "nl3 256 threads": fwd3(_variant=256),
        "nl3 general": fwd3(_variant=-1)})
    t_bwd = _alternating_ms({
        "nl2": lambda: gs.bwd_sweep(lemg2, trans, nl=2, K_real=K_real),
        "nl3": lambda: gs.bwd_sweep(lemg, trans, nl=3, K_real=K_real)})
    fmt = lambda d: ", ".join(f"{k} {v:.3f} ms" for k, v in d.items())
    print(f"gibbs_fwd at NL = 2 and 3 (K={K}, timed in turn): {fmt(t_fwd)}", flush=True)
    print(f"gibbs_bwd at NL = 2 and 3 (K={K}, timed in turn): {fmt(t_bwd)}", flush=True)
    steps = 20000
    floor_ns = {v: _median_ms(lambda: gs.chain_floor(steps, 128, B, "cuda", values=v), 3)
                * 1e6 / steps for v in (8, 16)}
    live_b = (args[3][:, 2] == 0).sum(dim=(0, 1))
    fwd_steps = G + int(live_b.max())
    print(f"chain floor at 128 threads: one 16-value reduction {floor_ns[16]:.1f} ns, one 8-value "
          f"{floor_ns[8]:.1f} ns; gibbs_fwd_nl3 walks {fwd_steps} dependent steps on its longest "
          f"chain = {2 * fwd_steps * floor_ns[8] / 1e6:.3f} ms with two 8-value reductions a "
          f"step (the kernel's form), {fwd_steps * floor_ns[16] / 1e6:.3f} ms with one of 16",
          flush=True)
    rows = [_row("gibbs_fwd_nl3", "gibbs_sweep.cu", "gibbs_pallas.py:56", err, t_fwd["nl3"],
                 plain_ms, *_fwd_work(args, got, K_real)),
            _row("gibbs_bwd_nl3", "gibbs_sweep.cu", "gibbs_pallas.py:351", err_b, t_bwd["nl3"],
                 plain_b, *_bwd_work(lemg, trans, got_b, K_real))]

    rows.append(check_dosage(3, got[1], got_b, words_T, K_real, 0.001))
    return rows


def check_dosage(nl, alphas, beta, words_T, K_real, eps):
    """The dosage kernel against its plain version (atol 1e-5) at the table
    shape, and against its previous form, timed in turn with it (4 rounds
    of 7). Returns its row."""
    from quilt_tpu_torch.kernels import gibbs_dosage as gd

    G, BN, K = alphas.shape
    name = "gibbs_dos" + ("" if nl == 2 else "_nl3")
    hd_r, plain_ms = _timed(lambda: gd.dosage_sweep_plain(alphas, beta, words_T, K_real, eps, nl))
    hd = gd.dosage_sweep(alphas, beta, words_T, nl, K_real, eps)
    hd_p = gd.dosage_sweep(alphas, beta, words_T, nl, K_real, eps, _prev=True)
    err = (hd - hd_r).abs().max().item()
    err_p = (hd_p - hd_r).abs().max().item()
    print(f"{name}: max |dosage err| {err:.3e}, previous form {err_p:.3e} (tolerance atol 1e-5)",
          flush=True)
    if not (err <= 1e-5 and err_p <= 1e-5):
        _fail(f"{name} disagrees with its plain version")
    t = _alternating_ms({
        "new": lambda: gd.dosage_sweep(alphas, beta, words_T, nl, K_real, eps),
        "previous form": lambda: gd.dosage_sweep(alphas, beta, words_T, nl, K_real, eps,
                                                 _prev=True)})
    nbytes, flops = _dos_work(alphas, beta, words_T, hd, K_real)
    bound = _bound(nbytes, flops)[0]
    print(f"{name} at {G} grids x {BN} state rows x K={K} (K_real {K_real}), timed in turn: new "
          f"{t['new']:.3f} ms, previous form {t['previous form']:.3f} ms; 50% of the bound "
          f"(bound / 0.5) {bound / 0.5:.4f} ms", flush=True)
    row = _row(name, "gibbs_dosage.cu", "gibbs_pallas.py:420", err, t["new"], plain_ms, nbytes,
               flops)
    row["previous_form_ms"] = t["previous form"]
    return row


def check_global_forms(G=32, B=8, W=4, K=10368, K_time=12288, G_path=512):
    """The forms past the shared-memory ones, at a small G. The forward's
    cluster forms (NL = 2 and 3) at K = 10,368 (the wide path's Ksubset),
    12,288 and their capacity, and the bank's at 6,272 (512 grids x 4
    chains), 8,192 (the wide NIPT path's K) and 12,288, against the plain
    versions, two launches equal bit for bit; each timed in turn with the
    global form it took over from (4 rounds of 7) at the kernels' timing
    shapes and at 512 grids (the main path's G), beside the cluster
    exchange's floor (the "cluster step split" lines); the backward's
    cluster form in check_bwd_forms. The global forms past the cluster
    forms' capacity (the forward at 16,512 / 12,416, the bank and the
    backward at 16,512), and the dosage kernel (one form at any K) at
    30,000. Returns the rows gibbs_fwd_global, gibbs_fwd_global_nl3,
    gibbs_bwd_global, nipt_bank_global, gibbs_fwd_cluster,
    gibbs_fwd_cluster_nl3, nipt_bank_cluster and gibbs_bwd_cluster."""
    import numpy as np
    import torch
    from quilt_tpu_torch.kernels import gibbs_dosage as gd
    from quilt_tpu_torch.kernels import gibbs_sweep as gs
    from quilt_tpu_torch.kernels import nipt_bank as nb
    from quilt_tpu_torch.simulate import random_sweep_state

    global_rows, cluster_rows = [], []
    state = lambda nl, k, seed, g=G: [torch.from_numpy(x).cuda() for x in random_sweep_state(
        np.random.default_rng(seed), g, B, W, k, k - 68, W, nl=nl)]
    steps_of = lambda args: args[0].shape[0] + int((args[3][:, 2] == 0).sum()) / B + 1
    for nl in (2, 3):
        prior = (0.5, 0.5) if nl == 2 else (0.5, 0.45, 0.05)
        sfx = "" if nl == 2 else "_nl3"
        kw = lambda k: dict(nl=nl, K_real=k - 68, it_mode=2, prior=prior)
        plain = lambda a, k: gs.fwd_sweep_plain(*a, K_real=k - 68, it_mode=2, nl=nl, prior=prior)
        cap = gs._CLUSTER_COLS[nl]
        # the cluster form at the wide path's K, the timing K and its capacity
        err, row = 0.0, None
        for Kc in sorted({K, K_time, cap}):
            if gs.fwd_form(Kc, nl) != gs.CLUSTER:
                _fail(f"the forward sweep at K={Kc}, nl={nl} does not take its cluster form")
            args = state(nl, Kc, SEED + 7 + nl + Kc)
            ref, plain_ms = _timed(lambda: plain(args, Kc))
            got = gs.fwd_sweep(*args, **kw(Kc))
            again = gs.fwd_sweep(*args, **kw(Kc))
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(got, again))
            got, e = _check_fwd(f"gibbs_fwd_cluster{sfx} at K={Kc} ({G} grids x {B} chains; two "
                                f"launches equal bit for bit: {equal})", got, ref, args)
            if not equal:
                _fail(f"gibbs_fwd_cluster{sfx}: two launches differ at K={Kc}")
            err = max(err, e)
            if Kc == K:
                row = _row(f"gibbs_fwd_cluster{sfx}", "gibbs_sweep.cu", "gibbs_pallas.py:56", 0.0,
                           None, plain_ms, *_fwd_work(args, got, Kc - 68))
                args_k, steps = args, steps_of(args)
        row["max_abs_err"] = err
        # timed in turn with the global form
        fwd = lambda a, k, **f: (lambda: gs.fwd_sweep(*a, **kw(k), **f))
        t = _alternating_ms({"cluster": fwd(args_k, K),
                             "global": fwd(args_k, K, _variant=gs.GLOBAL)})
        args_t = state(nl, K_time, SEED + 9 + nl)
        t_t = _alternating_ms({"cluster": fwd(args_t, K_time),
                               "global": fwd(args_t, K_time, _variant=gs.GLOBAL)})
        del args_t
        args_p = _tile_grids(args_k, G_path // G)
        t_p = _alternating_ms({"cluster": fwd(args_p, K),
                               "global": fwd(args_p, K, _variant=gs.GLOBAL)})
        steps_p = steps_of(args_p)
        del args_p
        vals = 8 if nl == 2 else 12
        floor_us = _median_ms(lambda: gs.cluster_floor(20000, B, "cuda", values=vals),
                              3) * 1e3 / 20000
        row.update(ms=t["cluster"], previous_form_ms=t["global"],
                   ms_at_K12288=t_t["cluster"], previous_form_ms_at_K12288=t_t["global"],
                   ms_at_512_grids=t_p["cluster"], previous_form_ms_at_512_grids=t_p["global"])
        print(f"gibbs_fwd_cluster{sfx}, timed in turn (4 rounds of 7; 8 blocks x 256 chain "
              f"threads a chain): at {G} grids x {B} chains x K={K}: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in t.items())
              + f"; at K={K_time}: cluster {t_t['cluster']:.3f}, global {t_t['global']:.3f} ms; "
              f"at {G_path} grids x K={K}: cluster {t_p['cluster']:.3f}, global "
              f"{t_p['global']:.3f} ms", flush=True)
        print(f"cluster step split, gibbs_fwd_cluster{sfx} (this run): {steps:.1f} dependent steps a "
              f"chain at {G} grids ({steps_p:.1f} at {G_path}): {1e3 * t['cluster'] / steps:.2f} us "
              f"a step ({1e3 * t_p['cluster'] / steps_p:.2f} at {G_path} grids; the global form "
              f"{1e3 * t['global'] / steps:.2f}); cluster exchange floor at 8 blocks x 256 threads "
              f"({vals} values: the block reductions, the push, the wait, the rank-order sums) "
              f"{floor_us:.3f} us a step; ptxas: "
              + "; ".join(n for n in PTXAS.get("gibbs_fwd_cluster_kernel", ["not reported"])
                          if f"NL={nl}" in n), flush=True)
        cluster_rows.append(row)
        del args_k
        # the global form past the cluster form's capacity
        Kg = cap + 128
        if gs.fwd_form(Kg, nl) != gs.GLOBAL:
            _fail(f"the forward sweep at K={Kg}, nl={nl} does not take its global form")
        args = state(nl, Kg, SEED + 13 + nl)
        ref, plain_ms = _timed(lambda: plain(args, Kg))
        got, err = _check_fwd(f"gibbs_fwd_global{sfx} at K={Kg}", gs.fwd_sweep(*args, **kw(Kg)),
                              ref, args)
        ms = _median_ms(fwd(args, Kg), 5)
        print(f"gibbs_fwd_global{sfx} at {G} grids x {B} chains x {W} slots x K={Kg}: {ms:.3f} ms "
              f"(plain {plain_ms:.1f} ms)", flush=True)
        row = _row(f"gibbs_fwd_global{sfx}", "gibbs_sweep.cu", "gibbs_pallas.py:56", err, ms,
                   plain_ms, *_fwd_work(args, got, Kg - 68))
        row["K"] = Kg
        global_rows.append(row)
        del args, got, ref

    bwd_row, bwd_cluster_row = check_bwd_forms(G, K, G_path)

    # the bank's cluster form, where 9K + 3G floats outgrow a block's shared memory
    Gb, Bb = 512, 4
    bank_err, brow = 0.0, None
    for Gc, Bc, Kc in ((Gb, Bb, 6272), (G, 14, 8192), (G, Bb, K_time)):
        if nb.bank_form(Kc, Gc) != gs.CLUSTER:
            _fail(f"the bank at {Gc} grids x K={Kc} does not take its cluster form")
        args = _bank_state(Gc, Bc, Kc, Kc - 72, np.random.default_rng(SEED + 8 + Kc))
        (ref_c, ref_p), plain_ms = _timed(lambda: nb.bank_scan_plain(*args))
        got_c, got_p = nb.bank_scan(*args)
        again = nb.bank_scan(*args)
        torch.cuda.synchronize()
        same = (got_c == ref_c).all(dim=0)
        err = (got_p - ref_p)[:, same].abs().max().item()
        equal = torch.equal(got_c, again[0]) and torch.equal(got_p, again[1])
        print(f"nipt_bank_cluster at {Gc} grids x {Bc} chains x K={Kc} (K_real {Kc - 72}): "
              f"{int(same.sum())}/{Bc} chains draw the same relabellings, max |probability err| "
              f"{err:.3e} (tolerance atol 1e-4), two launches equal bit for bit: {equal}",
              flush=True)
        if 1.0 - int(same.sum()) / Bc > PARTED_CHAINS_BOUND or not err <= 1e-4 or not equal:
            _fail(f"nipt_bank_cluster disagrees with its plain version at K={Kc}")
        bank_err = max(bank_err, err)
        if Kc == 6272:
            n_ends = int(args[5].sum())
            nbytes = (Gb * 3 * Bb * (Kc - 72) * 4 + n_ends * (3 * (Kc - 72) + 7) * 4
                      + _nbytes(args[2], args[5], args[6], ref_c, ref_p))
            brow = _row("nipt_bank_cluster", "nipt_bank.cu", "gibbs.py:502", 0.0, None, plain_ms,
                        nbytes, 6 * 9 * Gb * Bb * (Kc - 72))
            bank = lambda a, **f: (lambda: nb.bank_scan(*a, **f))
            t = _alternating_ms({"cluster": bank(args), "global": bank(args, _variant=gs.GLOBAL)})
        else:
            tk = _alternating_ms({"cluster": bank(args), "global": bank(args, _variant=gs.GLOBAL)})
            tag = f"{Gc}_grids_K{Kc}"
            brow[f"ms_at_{tag}"], brow[f"previous_form_ms_at_{tag}"] = tk["cluster"], tk["global"]
            print(f"nipt_bank_cluster at {Gc} grids x {Bc} chains x K={Kc}, timed in turn: cluster "
                  f"{tk['cluster']:.3f} ms, global {tk['global']:.3f} ms", flush=True)
        del args
    floor_us = _median_ms(lambda: nb.bank_cluster_floor(20000, Bb, "cuda"), 3) * 1e3 / 20000
    brow.update(max_abs_err=bank_err, ms=t["cluster"], previous_form_ms=t["global"])
    print(f"nipt_bank_cluster, timed in turn (4 rounds of 7; 16 blocks a chain) at "
          f"{Gb} grids x {Bb} chains x K=6272: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in t.items()), flush=True)
    print(f"cluster step split, nipt_bank_cluster (this run): {1e3 * t['cluster'] / Gb:.2f} us a "
          f"grid step (the global form {1e3 * t['global'] / Gb:.2f}); cluster exchange floor at 16 "
          f"blocks x 128 threads (the 16-slot block reduction, then 12 values pushed, the wait, "
          f"the rank-order sums) {floor_us:.3f} us a step; ptxas: "
          + "; ".join(PTXAS.get("nipt_bank_cluster_kernel", ["not reported"])), flush=True)
    cluster_rows.append(brow)

    # the bank's global form past the cluster form's capacity
    Kg = nb._CLUSTER_COLS + 128
    if nb.bank_form(Kg, G) != gs.GLOBAL:
        _fail(f"the bank at K={Kg} does not take its global form")
    args = _bank_state(G, Bb, Kg, Kg - 72, np.random.default_rng(SEED + 10))
    (ref_c, ref_p), plain_ms = _timed(lambda: nb.bank_scan_plain(*args))
    got_c, got_p = nb.bank_scan(*args)
    torch.cuda.synchronize()
    same = (got_c == ref_c).all(dim=0)
    err = (got_p - ref_p)[:, same].abs().max().item()
    print(f"nipt_bank_global at {G} grids x {Bb} chains x K={Kg} (K_real {Kg - 72}): "
          f"{int(same.sum())}/{Bb} chains draw the same relabellings, max |probability err| "
          f"{err:.3e} (tolerance atol 1e-4)", flush=True)
    if 1.0 - int(same.sum()) / Bb > PARTED_CHAINS_BOUND or not err <= 1e-4:
        _fail("nipt_bank_global disagrees with its plain version")
    n_ends = int(args[5].sum())
    nbytes = (G * 3 * Bb * (Kg - 72) * 4 + n_ends * (3 * (Kg - 72) + 7) * 4
              + _nbytes(args[2], args[5], args[6], ref_c, ref_p))
    row = _row("nipt_bank_global", "nipt_bank.cu", "gibbs.py:502", err,
               _median_ms(lambda: nb.bank_scan(*args), 5), plain_ms, nbytes,
               6 * 9 * G * Bb * (Kg - 72))
    row["K"] = Kg
    print(f"nipt_bank_global at {G} grids x {Bb} chains x K={Kg}: {row['ms']:.3f} ms", flush=True)
    rows = global_rows + [bwd_row, row] + cluster_rows + [bwd_cluster_row]
    del args

    # the dosage kernel far past the previous form's shared-memory plane
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    Gd, Bd, Kd = 8, 4, 30000
    alphas = torch.rand((Gd, 2 * Bd, Kd), generator=gen, device="cuda")
    beta = 0.1 + 0.9 * torch.rand((Gd, 2 * Bd, Kd), generator=gen, device="cuda")
    words = torch.randint(-2**31, 2**31 - 1, (Gd, Bd, Kd), generator=gen, device="cuda",
                          dtype=torch.int64).to(torch.int32)
    hd_r, plain_ms = _timed(lambda: gd.dosage_sweep_plain(alphas, beta, words, Kd - 10, 0.001))
    hd = gd.dosage_sweep(alphas, beta, words, 2, Kd - 10, 0.001)
    err = (hd - hd_r).abs().max().item()
    ms = _median_ms(lambda: gd.dosage_sweep(alphas, beta, words, 2, Kd - 10, 0.001), 5)
    print(f"gibbs_dos at {Gd} grids x {2 * Bd} state rows x K={Kd}: {ms:.3f} ms (plain "
          f"{plain_ms:.1f} ms, bound {_bound(*_dos_work(alphas, beta, words, hd, Kd - 10))[0]:.4f} "
          f"ms), "
          f"max |dosage err| {err:.3e} (tolerance atol 1e-5)", flush=True)
    if not err <= 1e-5:
        _fail(f"gibbs_dos at K={Kd} disagrees with its plain version")
    _print_rows(rows)
    return rows


def _bwd_state(G, rows, K, gen):
    """A backward sweep's input on the card: lemg uniform in [-20, 0] and
    the sweeps' transition rows (0.98 / 0.02, grid 0 (1, 0))."""
    import torch

    lemg = -20.0 * torch.rand((G, rows, K), generator=gen, device="cuda")
    trans = torch.tensor([[0.98], [0.02]], device="cuda").repeat(1, G)
    trans[:, 0] = torch.tensor([1.0, 0.0], device="cuda")
    return lemg, trans


# the backward's cluster form: the shapes it is held to its plain version at
# ((state rows, K)), and those it is timed at in turn with the global form
# ((grids, rows, K)): the timing shape's 16 rows and the wide path's 28 at its
# 32 grids and K = 10,368, the forms' capacity (wide_nipt12k's 84 rows at
# 12,288, wide16k's 112 at 16,384), the main path's 512 grids
BWD_CHECKED = ((16, 10368), (112, 10368), (84, 12288), (112, 16384), (16, 10241))
BWD_TIMED = ((32, 16, 10368), (32, 28, 10368), (32, 16, 12288), (32, 16, 16384),
             (512, 16, 10368), (32, 112, 10368), (512, 112, 10368), (32, 84, 12288),
             (32, 112, 16384), (512, 112, 16384))


def check_bwd_forms(G, K, G_path):
    """The backward sweep past the general variant: gibbs_bwd_cluster
    against its plain version at BWD_CHECKED (rtol 1e-5 / atol 1e-6, two
    launches equal bit for bit), timed in turn with gibbs_bwd_global (4
    rounds of 7) at BWD_TIMED with the plan the launcher took there, the
    "cluster bwd step split" (the SPLIT instantiation's clock counts of the
    ring waits, block reductions and exchanges, in us a grid, beside the
    exchange floor at the record's width, 3 values); the global form at
    16,512, past the capacity. Returns the rows (gibbs_bwd_global,
    gibbs_bwd_cluster)."""
    import torch
    from quilt_tpu_torch.kernels import gibbs_sweep as gs

    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    err, row = 0.0, None
    for rows, Kc in BWD_CHECKED:
        lemg, trans = _bwd_state(G, rows, Kc, gen)
        K_real = Kc - 68 if Kc % 128 == 0 else Kc
        ref, plain_ms = _timed(lambda: gs.bwd_sweep_plain(lemg, trans, K_real))
        got = gs.bwd_sweep(lemg, trans, nl=2, K_real=K_real, _variant=gs.CLUSTER)
        again = gs.bwd_sweep(lemg, trans, nl=2, K_real=K_real, _variant=gs.CLUSTER)
        torch.cuda.synchronize()
        e = (got - ref).abs().max().item()
        equal = torch.equal(got, again)
        print(f"gibbs_bwd_cluster at {G} grids x {rows} state rows x K={Kc} (K_real {K_real}; "
              f"plan {gs.bwd_cluster_plan(Kc, rows, 'cuda')}): max |beta err| {e:.3e} "
              f"(tolerance rtol 1e-5, atol 1e-6), two launches equal bit for bit: {equal}",
              flush=True)
        if not torch.allclose(got, ref, rtol=1e-5, atol=1e-6) or not equal:
            _fail(f"gibbs_bwd_cluster disagrees with its plain version at {rows} x K={Kc}")
        err = max(err, e)
        if (rows, Kc) == (16, K):
            row = _row("gibbs_bwd_cluster", "gibbs_sweep.cu", "gibbs_pallas.py:351", 0.0, None,
                       plain_ms, *_bwd_work(lemg, trans, got, K_real))
        del lemg, trans, ref, got, again
    row["max_abs_err"] = err
    for Gt, rows, Kc in BWD_TIMED:
        lemg, trans = _bwd_state(Gt, rows, Kc, gen)
        bwd = lambda **f: (lambda: gs.bwd_sweep(lemg, trans, nl=2, K_real=Kc - 68, **f))
        t = _alternating_ms({"cluster": bwd(_variant=gs.CLUSTER),
                             "global": bwd(_variant=gs.GLOBAL)})
        form = "cluster" if gs.bwd_form(Kc) == gs.CLUSTER else "global"
        print(f"gibbs_bwd_cluster, timed in turn with gibbs_bwd_global (4 rounds of 7) at {Gt} "
              f"grids x {rows} state rows x K={Kc}: cluster {t['cluster']:.3f} ms, global "
              f"{t['global']:.3f} ms; {1e3 * t['cluster'] / (Gt - 1):.2f} / "
              f"{1e3 * t['global'] / (Gt - 1):.2f} us a grid step; plan "
              f"{gs.bwd_cluster_plan(Kc, rows, 'cuda')}; bwd_form takes the {form} form",
              flush=True)
        tag = "" if (Gt, rows, Kc) == (G, 16, K) else f"_at_{Gt}x{rows}x{Kc}"
        row[f"ms{tag}"], row[f"previous_form_ms{tag}"] = t["cluster"], t["global"]
        del lemg, trans
    # the plan's shape against the other at the timing shape's rows and a full batch's
    for Gt, rows, Kc in ((512, 16, 10368), (512, 112, 10368), (512, 112, 16384)):
        lemg, trans = _bwd_state(Gt, rows, Kc, gen)
        bwd = lambda **f: (lambda: gs.bwd_sweep(lemg, trans, nl=2, K_real=Kc - 68,
                                                _variant=gs.CLUSTER, **f))
        plans = {c: gs.bwd_cluster_plan(Kc, rows, "cuda", c) for c in (104, 204)}
        t = _alternating_ms({"plan": bwd(), **{f"{p['threads']} x {p['cols']} ({p['active']} "
                                                 f"clusters at once)": bwd(_shape=c)
                                                 for c, p in plans.items()}})
        print(f"gibbs_bwd_cluster shapes at {Gt} grids x {rows} state rows x K={Kc}, ring depth "
              f"4, timed in turn (the plan: {gs.bwd_cluster_plan(Kc, rows, 'cuda')}): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in t.items()), flush=True)
        del lemg, trans
    # below the form's range, the general variant at the wide NIPT path's K and rows
    lemg, trans = _bwd_state(G, 42, 8192, gen)
    bwd = lambda **f: (lambda: gs.bwd_sweep(lemg, trans, nl=3, K_real=8192 - 68, **f))
    t = _alternating_ms({"cluster": bwd(_variant=gs.CLUSTER), "general": bwd()})
    print(f"gibbs_bwd_cluster below its range, timed in turn with the form bwd_form takes "
          f"there (form {gs.bwd_form(8192)}) at {G} grids x 42 state rows x K=8192: cluster "
          f"{t['cluster']:.3f} ms, general {t['general']:.3f} ms", flush=True)
    row["ms_at_32x42x8192"], row["general_form_ms_at_32x42x8192"] = t["cluster"], t["general"]
    del lemg, trans
    # the step split at the main path's grids and the wide path's rows
    lemg, trans = _bwd_state(G_path, 16, K, gen)
    ms = _median_ms(lambda: gs.bwd_cluster_split(lemg, trans, K - 68), 5)
    _, split = gs.bwd_cluster_split(lemg, trans, K - 68)
    torch.cuda.synchronize()
    share = (split[..., 1:].sum(dim=(0, 1)) / split[..., 0].sum()).tolist()
    us = 1e3 * ms / (G_path - 1)
    floor_us = _median_ms(lambda: gs.cluster_floor(20000, 16, "cuda", values=3), 3) * 1e3 / 20000
    print(f"cluster bwd step split, gibbs_bwd_cluster (this run; {G_path} grids x 16 rows x "
          f"K={K}, plan {gs.bwd_cluster_plan(K, 16, 'cuda')}): {us:.2f} us a grid step with "
          f"the clock counts on; ring wait {share[0] * us:.2f}, block reduction "
          f"{share[1] * us:.2f}, exchange {share[2] * us:.2f}, the rest (exponentials, "
          f"beta written) {(1 - sum(share)) * us:.2f} us a grid; cluster exchange floor at 8 "
          f"blocks x 256 threads, 3 values {floor_us:.3f} us a step; ptxas: "
          + "; ".join(PTXAS.get("gibbs_bwd_cluster_kernel", ["not reported"])), flush=True)
    row.update(step_split_us=dict(step=us, ring_wait=share[0] * us, block_reduction=share[1] * us,
                                  exchange=share[2] * us, floor=floor_us))
    del lemg, trans
    # the global form past the cluster form's capacity
    Kg = gs._BWD_CLUSTER_COLS + 128
    if gs.bwd_form(Kg) != gs.GLOBAL:
        _fail(f"the backward sweep at K={Kg} does not take its global form")
    lemg, trans = _bwd_state(G, 16, Kg, gen)
    ref, plain_ms = _timed(lambda: gs.bwd_sweep_plain(lemg, trans, Kg - 68))
    got = gs.bwd_sweep(lemg, trans, nl=2, K_real=Kg - 68)
    err_g = (got - ref).abs().max().item()
    ms_g = _median_ms(lambda: gs.bwd_sweep(lemg, trans, nl=2, K_real=Kg - 68), 5)
    print(f"gibbs_bwd_global at {G} grids x 16 state rows x K={Kg}: {ms_g:.3f} ms (plain "
          f"{plain_ms:.1f} ms), max |beta err| {err_g:.3e} (tolerance rtol 1e-5, atol 1e-6)",
          flush=True)
    if not torch.allclose(got, ref, rtol=1e-5, atol=1e-6):
        _fail("gibbs_bwd_global disagrees with its plain version")
    grow = _row("gibbs_bwd_global", "gibbs_sweep.cu", "gibbs_pallas.py:351", err_g, ms_g,
                plain_ms, *_bwd_work(lemg, trans, got, Kg - 68))
    grow["K"] = Kg
    return grow, row


def _tile_grids(args, reps):
    """A forward sweep's state over reps x its grids: the grids repeated
    in order on the card (timings at a long chain without a host-built
    state)."""
    import torch

    lemg, beta, lem_pad, slots, first, lab, trans, cnt = args
    tile = lambda x, d: torch.cat([x] * reps, dim=d).contiguous()
    return [tile(lemg, 0), tile(beta, 0), tile(lem_pad, 0), tile(slots, 0), first, lab,
            tile(trans, 1), tile(cnt, 1)]


def _bank_state(G, B, K, K_real, rng):
    """The bank's inputs at B chains x K haplotypes x G grids, ~12 blocks a
    chain at random grids, from rng."""
    import numpy as np
    import torch
    from quilt_tpu_torch.simulate import random_sweep_state

    lemg, beta = (torch.from_numpy(x).cuda() for x in random_sweep_state(
        rng, G, B, 4, K, K_real, 4, nl=3)[:2])
    trans = torch.from_numpy(np.stack([np.full(G, 0.98), np.full(G, 0.02)]).astype(np.float32))
    trans[:, 0] = torch.tensor([1.0, 0.0])
    is_end = torch.from_numpy((rng.random((G, B)) < 12 / G).astype(np.int32))
    is_end[G - 1] = 1
    is_end = is_end.cuda()
    rest = (torch.from_numpy(rng.normal(0, 2, (G, B, 6)).astype(np.float32)).cuda(),
            torch.from_numpy(rng.random((G, B)).astype(np.float32)).cuda())
    return (lemg, beta, trans.cuda(), *rest, is_end, torch.ones(6, device="cuda"), K_real)


def time_bank_forms(G=512, B=28, shapes=((256, 250), (1024, 1000))):
    """The bank's instantiations timed in turn at the K where they border
    (every register form that holds K and the general form, launched
    through the kernel's entry with its columns a thread): the
    "bank forms" lines, which chose the instantiations that the kernel
    keeps. Each form must draw what the wrapper's form draws, bit for bit."""
    import numpy as np
    import torch
    from quilt_tpu_torch.kernels import nipt_bank as nb

    for K, K_real in shapes:
        args = _bank_state(G, B, K, K_real, np.random.default_rng(SEED + K))
        chosen = torch.empty((G, B), dtype=torch.int32, device="cuda")
        probs = torch.empty((G, B, 6), dtype=torch.float32, device="cuda")
        scratch = torch.empty((B, nb._staged_floats(G) + 9 * K), device="cuda")

        def launch(cpt):
            nb.BANK_KERNEL.launch(*(a.data_ptr() for a in args[:7]), chosen.data_ptr(),
                                  probs.data_ptr(), G, B, K, K_real, cpt, 1.0 / K_real,
                                  scratch.data_ptr())

        cpts = [c for c in nb._BANK_CPTS if c * nb._NT >= K] + [nb.GENERAL, nb.GLOBAL]
        ref = nb.bank_scan(*args)
        for c in cpts:
            launch(c)
            if not (torch.equal(chosen, ref[0]) and torch.equal(probs, ref[1])):
                _fail(f"nipt_bank: the form {c} (columns a thread; -1 general, -2 global) at "
                      f"K={K} draws otherwise than the wrapper's form ({nb.bank_form(K, G)})")
        t = _alternating_ms({c: (lambda c=c: launch(c)) for c in cpts})
        names = {nb.GENERAL: "general", nb.GLOBAL: "global"}
        print(f"bank forms at {B} chains x K={K} (K_real {K_real}) x {G} grids, timed in turn "
              f"(4 rounds of 7; the wrapper takes {nb.bank_form(K, G)}; all draw the same bits): "
              + ", ".join(f"{names.get(c, f'<{c}>')} {v:.3f} ms" for c, v in t.items()),
              flush=True)


def check_nipt_bank(G, K, K_real, B=28):
    """The forward bank of the NIPT block move against its plain version (the
    Python loop over the grids) at the NIPT path's shape: B chains of one
    batch, ~12 blocks a chain at random grids; the kernel timed in turn with
    the previous form (the route: its e and beta * mask planes built, then
    its kernel; and its kernel alone on planes built beforehand) and with
    the same launch with no block end but the last (the block ends' share),
    beside the floor of one step's reduction (the "bank step split" line).
    Returns its row."""
    import numpy as np
    import torch
    from quilt_tpu_torch.kernels import nipt_bank as nb

    args = _bank_state(G, B, K, K_real, np.random.default_rng(SEED + 6))
    lemg, is_end = args[0], args[5]
    ref_c, ref_p = nb.bank_scan_plain(*args)
    n_ends = int(is_end.sum())
    forms = {"new": {}, "previous form": dict(_prev=True)}
    err = 0.0
    for label, form in forms.items():
        got_c, got_p = nb.bank_scan(*args, **form)
        again = nb.bank_scan(*args, **form)
        torch.cuda.synchronize()
        # a uniform within rounding of a cumulative probability may draw the
        # neighbouring relabelling, and that chain's bank then differs for good
        same = (got_c == ref_c).all(dim=0)                               # [B]
        parted = 1.0 - int(same.sum()) / B
        e = (got_p - ref_p)[:, same].abs().max().item()
        equal = torch.equal(got_c, again[0]) and torch.equal(got_p, again[1])
        print(f"nipt_bank, {label}: {int(same.sum())}/{B} chains draw the same {n_ends} "
              f"relabellings ({100 * parted:.1f}% part, bound {100 * PARTED_CHAINS_BOUND:.0f}%; "
              f"drawn: {torch.bincount(got_c[is_end != 0].long(), minlength=6).tolist()}), max "
              f"|probability err| {e:.3e} (tolerance atol 1e-4), two launches equal bit for "
              f"bit: {equal}", flush=True)
        if parted > PARTED_CHAINS_BOUND or not e <= 1e-4 or not equal:
            _fail(f"nipt_bank ({label}) disagrees with its plain version")
        if label == "new":
            err = e
    last_only = torch.zeros_like(is_end)
    last_only[G - 1] = 1
    args_last = args[:5] + (last_only,) + args[6:]
    planes = nb._prev_planes(lemg, args[1], K_real)
    timed = {label: (lambda f=form: nb.bank_scan(*args, **f)) for label, form in forms.items()}
    timed["previous kernel alone"] = lambda: nb._prev_bank_scan(*planes, *args[2:])
    timed["no block end but the last"] = lambda: nb.bank_scan(*args_last)
    t = _alternating_ms(timed)
    del planes
    steps = 20000
    floor_ns = _median_ms(lambda: nb.bank_floor(steps, B, "cuda"), 3) * 1e6 / steps
    new_ms = t["new"]
    print("nipt_bank, timed in turn (4 rounds of 7; the previous form's route builds its two "
          "planes, its kernel alone reads them built beforehand): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in t.items()), flush=True)
    print(f"bank step split at {B} chains x K={K} x {G} grids (this run): nipt_bank "
          f"{1e3 * new_ms / G:.2f} us a grid step (previous kernel "
          f"{1e3 * t['previous kernel alone'] / G:.2f}); floor of one step's reduction (16 "
          f"slots, a record a warp, one barrier, 128 threads) {floor_ns:.1f} ns = "
          f"{G * floor_ns / 1e6:.3f} ms a call; block ends ({n_ends}, "
          f"~{n_ends / B:.1f} a chain): {new_ms - t['no block end but the last']:.3f} ms "
          f"({100 * (1 - t['no block end but the last'] / new_ms):.1f}%); ptxas: "
          + "; ".join(PTXAS.get("nipt_bank_kernel", ["not reported"])
                      + PTXAS.get("nipt_bank_general_kernel", [])), flush=True)
    time_bank_forms(G, B)
    # what this run's data needs: lemg's real haplotypes once; beta's real
    # haplotypes, the class-count terms and the uniform only where a chain's
    # block ends; the transitions, the block ends, the mask and the outputs
    # whole. Operations: ~54 a (grid, chain, real haplotype).
    end_bytes = n_ends * (3 * K_real + 6 + 1) * 4
    nbytes = (G * 3 * B * K_real * 4 + end_bytes
              + _nbytes(args[2], is_end, args[6], ref_c, ref_p))
    row = _row("nipt_bank", "nipt_bank.cu", "gibbs.py:502", err, new_ms,
               _median_ms(lambda: nb.bank_scan_plain(*args), 1), nbytes,
               6 * 9 * G * B * K_real)
    row["previous_form_ms"] = t["previous form"]
    row["previous_kernel_ms"] = t["previous kernel alone"]
    return row


def _print_rows(rows):
    for r in rows:
        print(f"  {r['name']}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)


def _random_dl(fb, B, gen, eps=0.001):
    import torch

    gl = 0.05 + 0.95 * torch.rand((B, 2, fb.S), generator=gen, device="cuda")
    t0 = gl[:, 0] * (1 - eps) + gl[:, 1] * eps
    t1 = gl[:, 0] * eps + gl[:, 1] * (1 - eps)
    return gl, (torch.log(t1) - torch.log(t0)).contiguous()


def _topk_bad(ti, tv_r, ti_r, g):
    """[thinned grids, rows]: where the top-K indices ti disagree with the
    plain version's beyond what its values leave open (_topk_agree), and
    the places the values settle (ranks followed by a gap > 1e-3)."""
    v, i, i_r = tv_r[g], ti[g], ti_r[g]
    firm = (v[:, :, :-1] - v[:, :, 1:]) > 1e-3
    apart = firm.clone()
    apart[:, :, 1:] &= firm[:, :, :-1]
    bad = ((i[:, :, :-1] != i_r[:, :, :-1]) & apart).any(-1)
    for k in range(firm.shape[2]):
        sets = (i[:, :, :k + 1].sort(-1).values != i_r[:, :, :k + 1].sort(-1).values).any(-1)
        bad |= firm[:, :, k] & sets
    return bad, int(firm.sum())


def _topk_agree(tv, ti, tv_r, ti_r, thin):
    """Max top-K value error, whether the indices agree where the values
    settle them, and the number of ranks whose plain value exceeds the next
    by more than 1e-3. Values closer than that may come in either order
    (haplotypes with equal emissions wherever the reads reach tie, as on a
    founder-mosaic panel at low coverage, and rounding orders near-ties):
    so a rank's index must be the plain version's where its value stands
    more than 1e-3 from both neighbours, and at each rank k followed by a
    gap of more than 1e-3 the ranks 0..k must hold the same haplotypes as a
    set."""
    bad, n_firm = _topk_bad(ti, tv_r, ti_r, thin >= 0)
    return (tv - tv_r).abs().max().item(), not bool(bad.any()), n_firm


def _topk_mismatch(tv, ti, tv_r, ti_r, thin):
    """The first (thinned grid, row) that fails _topk_agree, as text: both
    value and index lists."""
    g = thin >= 0
    bad = _topk_bad(ti, tv_r, ti_r, g)[0].nonzero()
    if not len(bad):
        return "none"
    n, b = bad[0].tolist()
    fmt = lambda t: [round(x, 6) if isinstance(x, float) else x for x in t[g][n, b].tolist()]
    return (f"grid {n} of the thinned, row {b}: kernel {fmt(tv)} at {fmt(ti)}; plain "
            f"{fmt(tv_r)} at {fmt(ti_r)}")


def check_tiled_kernels(fb, B=28, K_top=8, eps=0.001):
    """The three K-split FB kernels against their plain versions at the
    large world's shape on all its grids, the backward (one launch an FB
    call: every chunk's rebuild and reverse sweep) timed in turn with its
    previous form (a remat and a backward launch per chunk of 16 grids) and
    with no thinned grid, beside its cluster exchange's floor (the "tiled
    step split" line), then fb_tiled_core against the fused fb_core."""
    import torch
    from quilt_tpu_torch.kernels import fb as fbk

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    dev = fb.device_tensors("cuda")
    words, trans2, thin = dev["words"], dev["trans2"], dev["thin_flag"]
    Gp = fb.nGrids
    splits = fbk.fb_plan(B, fb)[2]
    kt = fb.K_pad // splits
    CG = fbk.tiled_cg(kt, Gp)
    smem, cpt = fbk._tiled_storage(CG, kt, K_top)
    # the wrapper chooses the interval and storage from its copy of the
    # backward's shared-memory layout: it must equal the kernel library's
    for args in ((CG, kt, K_top, smem), (2 * CG, kt, 32, True), (CG, kt, 32, False)):
        if fbk.kernel_tiled_smem_bytes(*args) != fbk._bwd_tiled_smem_bytes(*args):
            _fail(f"the tiled backward's shared memory at {args} differs between "
                  f"kernels/fb.py and fb_tiled.cu")
    gl, dl = _random_dl(fb, B, gen, eps)
    cells = B * Gp * fb.K
    print(f"tiled FB kernels at {B} rows x K={fb.K} (K_pad {fb.K_pad}) x {Gp} grids, "
          f"{splits} blocks per row, checkpoint interval {CG}, the chunk's alphas in "
          f"{'shared' if smem else 'global'} memory, {cpt} haplotypes a thread in registers "
          f"(0: the general form); plain versions on all {Gp} grids", flush=True)
    rows = []

    r = _check_tiled(dl, words, trans2, thin, fb.K, kt, K_top, eps)
    mx, (ck, S, lg), got = r["mx"], r["fwd"], r["bwd"]
    # the previous form adds the log-ratios in the plain version's order
    if not torch.equal(fbk.fb_max_tiled(dl, words, fb.K, kt, _prev=True), r["mx_r"]):
        _fail("fb_max_tiled's previous form differs from the plain version")
    t_max = _alternating_ms({
        "new": lambda: fbk.fb_max_tiled(dl, words, fb.K, kt),
        "previous form": lambda: fbk.fb_max_tiled(dl, words, fb.K, kt, _prev=True)})
    max_bound = _bound(_nbytes(dl, words, mx), 33 * cells)[0]
    print(f"fb_max_tiled at {B} rows x K={fb.K} x {Gp} grids, timed in turn: new "
          f"{t_max['new']:.3f} ms, previous form ({splits} blocks a row) "
          f"{t_max['previous form']:.3f} ms; 50% of the bound (bound / 0.5) "
          f"{max_bound / 0.5:.4f} ms; ptxas: " + "; ".join(PTXAS.get("fb_max_tiled_kernel", ["not reported"])), flush=True)
    row = _row("fb_max_tiled", "fb_tiled.cu", "fb_pallas.py:420", r["err_max"], t_max["new"],
               r["max_plain_ms"],
               _nbytes(dl, words, mx), 33 * cells)
    row["previous_form_ms"] = t_max["previous form"]
    rows.append(row)

    # the forward timed in turn with its previous form (alpha in a global
    # row, three barriers a step) and its general form, beside the floor of
    # its exchange (the "tiled forward step split" line); the two forms give
    # the same bits
    cpt_f = fbk._fwd_tiled_cpt(kt)
    fwd = lambda **v: (lambda: fbk.fb_forward_tiled(dl, words, trans2, mx, fb.K, kt, **v))
    fwd_forms = {"new": {}, "general form": dict(_general=True)}
    for label, form in fwd_forms.items():
        other = fwd(**form)()
        if not all(torch.equal(a, b) for a, b in zip(other, (ck, S, lg))):
            _fail(f"fb_fwd_tiled ({label}) differs from the default form")
    old_f = fwd(_prev=True)()
    if not (torch.allclose(old_f[0], ck, rtol=1e-5, atol=1e-30)
            and torch.allclose(old_f[1], S, rtol=1e-5, atol=0)):
        _fail("the previous tiled forward disagrees with the new one")
    t_fwd = _alternating_ms({**{k: fwd(**v) for k, v in fwd_forms.items()},
                             "previous form": fwd(_prev=True)})
    # and at the other split of the two that fb_plan weighs at this shape
    kt2 = fb.K_pad // (4 if splits == 8 else 8)
    fwd2 = lambda **v: (lambda: fbk.fb_forward_tiled(dl, words, trans2, mx, fb.K, kt2, **v))
    t_fwd2 = _alternating_ms({"new": fwd2(), "previous form": fwd2(_prev=True)})
    steps = 5000
    ffloor_us = _median_ms(lambda: fbk.tiled_chain_floor(steps, B, splits, "cuda", fwd=True),
                           3) * 1e3 / steps
    print(f"fb_fwd_tiled ({cpt_f} haplotypes a thread in registers), "
          f"timed in turn over a whole FB call: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in t_fwd.items())
          + f"; at {fb.K_pad // kt2} blocks a row ({fbk._fwd_tiled_cpt(kt2)} a thread): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in t_fwd2.items()), flush=True)
    print(f"tiled forward step split at {B} rows x {kt} haplotypes a block (this run): "
          f"fb_fwd_tiled {1e3 * t_fwd['new'] / Gp:.2f} us a grid (previous form "
          f"{1e3 * t_fwd['previous form'] / Gp:.2f}), forward exchange floor {ffloor_us:.2f} us "
          f"a step (each warp's sum posted, one cluster barrier, the {splits} x 16 posts read) = "
          f"{Gp * ffloor_us / 1e3:.3f} ms a call; ptxas: "
          + "; ".join(PTXAS.get("fb_fwd_tiled_kernel", ["not reported"])), flush=True)
    row = _row("fb_fwd_tiled", "fb_tiled.cu", "fb_pallas.py:439", r["err_ck"], t_fwd["new"],
               r["fwd_plain_ms"],
               _nbytes(dl, words, trans2, mx, ck, S, lg), 40 * cells)
    row["previous_form_ms"] = t_fwd["previous form"]
    rows.append(row)

    # the backward timed in turn with its previous form (its own checkpoints
    # every 16 grids), on the same inputs with no thinned grid (the top-K's
    # share) and in its general form (e*beta in a global plane, the words
    # read in the step); the floor of its cluster exchange at this shape
    ck16 = fbk.fb_forward_tiled(dl, words, trans2, mx, fb.K, kt, CG=16)[0]
    old = fbk.fb_backward_tiled(dl, words, ck16, trans2, thin, mx, S, fb.K, K_top, eps, kt, 16,
                                _prev=True)
    err_old = (old[0] - got[0]).abs().max().item()
    err_d = r["err_d"]
    if err_old > 1e-4:
        _fail(f"the previous tiled backward's dosage is {err_old:.3e} from the new kernel's")
    no_thin = torch.full_like(thin, -1)
    bwd = lambda c, th, *a, **v: (lambda: fbk.fb_backward_tiled(dl, words, c, trans2, th, mx, S,
                                                                fb.K, K_top, eps, kt, *a, **v))
    t_bwd = _alternating_ms({"new": bwd(ck, thin), "no thinned grid": bwd(ck, no_thin),
                             "general form": bwd(ck, thin, _general=True),
                             "previous form": bwd(ck16, thin, 16, _prev=True)})
    steps = 5000
    floor_us = _median_ms(lambda: fbk.tiled_chain_floor(steps, B, splits, "cuda"), 3) * 1e3 / steps
    n_thin = int((thin >= 0).sum())
    new_ms, prev_ms = t_bwd["new"], t_bwd["previous form"]
    print(f"fb_bwd_tiled ({cpt} haplotypes a thread in registers), timed in turn over a whole "
          f"FB call: " + ", ".join(f"{k} {v:.3f} ms" for k, v in t_bwd.items())
          + f" (the previous form: {2 * Gp // 16} launches; its dosage {err_old:.3e} from the new "
          f"kernel's)", flush=True)
    print(f"tiled step split at {B} rows x {kt} haplotypes a block (this run): fb_bwd_tiled "
          f"{1e3 * new_ms / Gp:.2f} us a grid (rebuild + reverse step; previous form "
          f"{1e3 * prev_ms / Gp:.2f}), cluster exchange floor {floor_us:.2f} us a step "
          f"(the 34-value reduction, one cluster barrier, the posts' reads) = "
          f"{Gp * floor_us / 1e3:.3f} ms a call, top-K at the {n_thin} thinned grids "
          f"{new_ms - t_bwd['no thinned grid']:.3f} ms "
          f"({100 * (1 - t_bwd['no thinned grid'] / new_ms):.1f}%); ptxas: "
          + "; ".join(PTXAS.get("fb_bwd_tiled_kernel", ["not reported"])), flush=True)
    # operations per (row, grid, haplotype): ~40 to rebuild alpha (the
    # emission sum and the step), ~76 in the reverse step (emission, beta,
    # gamma and 32 dosage adds); each input read once, each output written once
    row = _row("fb_bwd_tiled", "fb_tiled.cu", "fb_pallas.py:539", err_d, new_ms, r["bwd_plain_ms"],
               _nbytes(dl, words, ck, trans2, thin, mx, S, *got), (40 + 76) * cells)
    row["also_replaces"] = "quilt_tpu/kernels/fb_pallas.py:494"
    row["previous_form_ms"] = prev_ms
    rows.append(row)

    # the whole tiled FB against the fused CUDA FB, whose backward keeps the
    # chunk's alphas in global planes at this K_pad
    cg_f = fbk.fused_cg(fb.K_pad, Gp)
    smem_f, cpt_f = fbk._bwd_storage(cg_f, fb.K_pad, K_top)
    print(f"fused fb_core at K={fb.K}: checkpoint interval {cg_f}, the chunk's alphas in "
          f"{'shared' if smem_f else 'global'} memory, {cpt_f} haplotypes a thread in registers "
          f"(0: the general form)", flush=True)
    if smem_f:
        _fail(f"the fused backward at K_pad={fb.K_pad} took the shared-memory storage")
    args = (gl, words, trans2, thin, fb.K, K_top, eps)
    d_t, l_t, tv_t, ti_t = fbk.fb_tiled_core(*args, k_tile=kt)
    d_f, l_f, tv_f, ti_f = fbk.fb_core(*args)
    torch.cuda.synchronize()
    err_d, err_l = (d_t - d_f).abs().max().item(), (l_t - l_f).abs().max().item()
    err_tv, idx_ok, n_firm = _topk_agree(tv_t, ti_t, tv_f, ti_f, thin)
    print(f"fb_tiled_core vs fused fb_core: max |dosage err| {err_d:.3e}, max |loglik err| {err_l:.3e}, "
          f"max |top-K value err| {err_tv:.3e}, indices equal where the values settle them: {idx_ok} "
          f"({n_firm} places) (tolerance dosage / top-K atol 1e-4, loglik 1e-2)", flush=True)
    if err_d > 1e-4 or err_l > 1e-2 or err_tv > 1e-4 or not idx_ok:
        _fail("fb_tiled_core disagrees with the fused fb_core")
    _print_rows(rows)
    return rows


def synthetic_fb(K, nGrids=512):
    """FB inputs of a random panel (random words, 2% jump rate, every tenth
    grid thinned; K_pad K rounded up to 128, as FBInputs.build pads):
    enough to time the FB families at a K between the worlds' without
    preparing another world."""
    import numpy as np
    from quilt_tpu_torch.inputs import FBInputs

    rng = np.random.default_rng(SEED + K)
    K_pad = -(-K // 128) * 128
    words = np.zeros((nGrids, K_pad), dtype=np.int32)
    words[:, :K] = rng.integers(-2**31, 2**31, (nGrids, K), dtype=np.int64).astype(np.int32)
    trans = np.tile(np.float32([0.98, 0.02]), (nGrids, 1))
    trans[0] = (1.0, 1.0)
    thin = np.full(nGrids, -1, dtype=np.int32)
    thin[::10] = np.arange(len(thin[::10]))
    return FBInputs(words=words, trans=trans, thin_flag=thin, K=K, K_pad=K_pad, nGrids=nGrids,
                    S=nGrids * 32, nSNPs=nGrids * 32)


def _form_name(cpt):
    from quilt_tpu_torch.kernels import fb as fbk

    return ("general" if cpt == 0 else f"staged, {cpt} a thread" if cpt == fbk._STAGED_CPT
            else f"registers, {cpt} a thread")


def tiled_forms(K_pad, splits, Gp, K_top=8):
    """The K-split FB's forms at K_pad / splits haplotypes a block, as text:
    the interval, the storage, the forward's and the backward's forms."""
    from quilt_tpu_torch.kernels import fb as fbk

    kt = K_pad // splits
    cg = fbk.tiled_cg(kt, Gp)
    smem, cpt = fbk._tiled_storage(cg, kt, K_top)
    return (f"{kt} haplotypes a block, checkpoint interval {cg}, the chunk's alphas in "
            f"{'shared' if smem else 'global'} memory; forms: fb_fwd_tiled "
            f"{_form_name(fbk._fwd_tiled_cpt(kt))}, fb_bwd_tiled {_form_name(cpt)}")


def _non_general(K_pad, splits, Gp, K_top=8):
    """Whether both K-split kernels take a form other than the general one
    at K_pad / splits haplotypes a block (they must, up to 24 a thread)."""
    from quilt_tpu_torch.kernels import fb as fbk

    kt = K_pad // splits
    return bool(fbk._fwd_tiled_cpt(kt) and fbk._tiled_storage(fbk.tiled_cg(kt, Gp), kt, K_top)[1])


# the K-split FB at its widest blocks, (rows, K, blocks a row, grids): the
# K100k batch's launch shape at 8 blocks a row (12,288 haplotypes a block)
# and at 16 (6,144), and a launch of a TOPMed-sized panel (K = 194,512,
# K_pad 194,560) at 16 (12,160; on 128 grids: its plain versions, 16 tiles
# a grid, took 25.6 s at 512); the first and the last are held against the
# plain versions
WIDE_TILED_SHAPES = ((84, 98304, 8, 512), (84, 98304, 16, 512), (16, 194512, 16, 128))
WIDE_TILED_CHECKED = ((84, 98304, 8, 512), (16, 194512, 16, 128))


def check_wide_tiled(K_top=8, eps=0.001):
    """The K-split forward and backward at WIDE_TILED_SHAPES on random
    panels and GLs: the forms they take (none the general form) and the
    clusters the card holds at once for each; at WIDE_TILED_CHECKED, the
    three kernels against their plain versions on all the grids
    (_check_tiled's tolerances; the forward's two launches equal bit for
    bit too); each form timed in turn with the general form at its own
    interval (the largest whose alpha planes fit, as the general form ran
    there before the staged form) and, backward, with no thinned grid,
    beside the exchange floors at that cluster size: the "tiled forward
    step split" and "tiled step split" lines, in us a grid a wave of
    clusters. Returns {kernel row name: [a dict a shape]}."""
    import torch
    from quilt_tpu_torch.kernels import fb as fbk

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    out = {"fb_fwd_tiled": [], "fb_bwd_tiled": []}
    steps = 3000
    ptx = lambda k: "; ".join(PTXAS.get(k, ["not reported"]))
    # kernels.fb._ACTIVE_CLUSTERS: the backward at one block an SM
    print("clusters the card holds at once, the backward at 4,096 haplotypes a block (one "
          "block an SM): " + ", ".join(f"{s} blocks {fbk.tiled_active_clusters(s, 4096)}"
                                       for s in fbk._SPLITS[1:])
          + f"; kernels.fb._ACTIVE_CLUSTERS {fbk._ACTIVE_CLUSTERS}", flush=True)
    for B, K, splits, grids in WIDE_TILED_SHAPES:
        fb = synthetic_fb(K, grids)
        dev = fb.device_tensors("cuda")
        words, trans2, thin = dev["words"], dev["trans2"], dev["thin_flag"]
        Gp, kt = fb.nGrids, fb.K_pad // splits
        cg = fbk.tiled_cg(kt, Gp)
        cpt = fbk._tiled_storage(cg, kt, K_top)[1]
        cpt_f = fbk._fwd_tiled_cpt(kt)
        # the general form's own interval: the largest whose alpha planes fit
        cg_g = next(c for c in (16, 8, 4, 2) if Gp % c == 0 and fbk._bwd_tiled_smem_bytes(
            c, kt, fbk._KTOP_RESERVE, 1) <= fbk._SMEM_LIMIT)
        act_b, act_f = fbk.tiled_active_clusters(splits, kt), fbk.tiled_active_clusters(
            splits, kt, fwd=True)
        where = f" at {B} rows x K={K} (K_pad {fb.K_pad}) x {Gp} grids, {splits} blocks a row"
        print(f"K-split FB{where}: {tiled_forms(fb.K_pad, splits, Gp, K_top)}; clusters of "
              f"{splits} blocks the card holds at once (cudaOccupancyMaxActiveClusters): "
              f"backward {act_b}, forward {act_f}", flush=True)
        if not cpt or not cpt_f:
            _fail(f"the K-split FB{where} took the general form")
        gl, dl = _random_dl(fb, B, gen, eps)
        r = {}
        if (B, K, splits, grids) in WIDE_TILED_CHECKED:
            r = _check_tiled(dl, words, trans2, thin, K, kt, K_top, eps, where)
            mx, (ck, S, lg), got = r["mx"], r["fwd"], r["bwd"]
            if not all(torch.equal(a, b) for a, b in zip(
                    fbk.fb_forward_tiled(dl, words, trans2, mx, K, kt), r["fwd"])):
                _fail(f"fb_fwd_tiled{where} gave other bits on a second launch")
        else:
            mx = fbk.fb_max_tiled(dl, words, K, kt)
            ck, S, lg = fbk.fb_forward_tiled(dl, words, trans2, mx, K, kt)
            got = fbk.fb_backward_tiled(dl, words, ck, trans2, thin, mx, S, K, K_top, eps, kt)
        fwd = lambda c, **v: (lambda: fbk.fb_forward_tiled(dl, words, trans2, mx, K, kt, c, **v))
        ck_g = fwd(cg_g, _general=True)()[0]
        gen_b = fbk.fb_backward_tiled(dl, words, ck_g, trans2, thin, mx, S, K, K_top, eps, kt,
                                      cg_g, _general=True)
        err_g = (gen_b[0] - got[0]).abs().max().item()
        if err_g > 1e-4:
            _fail(f"the general form's dosage{where} is {err_g:.3e} from the new form's")
        # (2 rounds of 5 launches: a backward launch here takes 30-90 ms)
        t_f = _alternating_ms({"new": fwd(cg), "general form": fwd(cg_g, _general=True)}, 2, 5)
        no_thin = torch.full_like(thin, -1)
        bwd = lambda c, th, cgv, **v: (lambda: fbk.fb_backward_tiled(
            dl, words, c, trans2, th, mx, S, K, K_top, eps, kt, cgv, **v))
        t_b = _alternating_ms({"new": bwd(ck, thin, cg), "no thinned grid": bwd(ck, no_thin, cg),
                               "general form": bwd(ck_g, thin, cg_g, _general=True)}, 2, 5)
        nb = min(B, act_b)
        floor_b = _median_ms(lambda: fbk.tiled_chain_floor(steps, nb, splits, "cuda"),
                             3) * 1e3 / steps
        floor_f = _median_ms(lambda: fbk.tiled_chain_floor(steps, nb, splits, "cuda", fwd=True),
                             3) * 1e3 / steps
        waves_b, waves_f = -(-B // act_b), -(-B // act_f)
        us = lambda ms, waves: 1e3 * ms / Gp / waves
        print(f"tiled forward step split{where} (this run): fb_fwd_tiled "
              f"({_form_name(cpt_f)}, interval {cg}) {t_f['new']:.3f} ms = {us(t_f['new'], waves_f):.2f} "
              f"us a grid a wave ({waves_f} waves of {act_f} clusters); general form (interval "
              f"{cg_g}) {t_f['general form']:.3f} ms = {us(t_f['general form'], waves_f):.2f} us; "
              f"forward exchange floor {floor_f:.2f} us a step ({nb} clusters); ptxas: "
              + ptx("fb_fwd_tiled_kernel"), flush=True)
        print(f"tiled step split{where} (this run): fb_bwd_tiled ({_form_name(cpt)}, interval "
              f"{cg}) {t_b['new']:.3f} ms = {us(t_b['new'], waves_b):.2f} us a grid a wave "
              f"({waves_b} waves of {act_b} clusters; rebuild + reverse step), no thinned grid "
              f"{t_b['no thinned grid']:.3f} ms (top-K "
              f"{100 * (1 - t_b['no thinned grid'] / t_b['new']):.1f}%); general form (interval "
              f"{cg_g}) {t_b['general form']:.3f} ms = {us(t_b['general form'], waves_b):.2f} us, "
              f"its dosage {err_g:.3e} from the new form's; cluster exchange floor {floor_b:.2f} us "
              f"a step ({nb} clusters); ptxas: " + ptx("fb_bwd_tiled_kernel"), flush=True)
        cells = B * Gp * K
        shape = f"{B} rows x K={K} x {Gp} grids, {splits} blocks a row"
        for name, t, form, work, err, plain in (
                ("fb_fwd_tiled", t_f, cpt_f, (_nbytes(dl, words, trans2, mx, ck, S, lg), 40 * cells),
                 r.get("err_ck"), r.get("fwd_plain_ms")),
                ("fb_bwd_tiled", t_b, cpt, (_nbytes(dl, words, ck, trans2, thin, mx, S, *got),
                                            (40 + 76) * cells), r.get("err_d"),
                 r.get("bwd_plain_ms"))):
            bound_ms, bound_by = _bound(*work)
            out[name].append(dict(shape=shape, form=_form_name(form), ms=t["new"],
                                  previous_form_ms=t["general form"], bound_ms=bound_ms,
                                  bound_by=bound_by, plain_ms=plain, max_abs_err=err,
                                  active_clusters=act_f if name == "fb_fwd_tiled" else act_b))
        del fb, dev, words, gl, dl, mx, ck, S, got, ck_g, gen_b, r
        torch.cuda.empty_cache()
    return out


def time_fb_plan(fb, rows_list=(28, 112)):
    """Both FB families at the plan's decision points: median ms of three
    whole-FB calls through fb_full_batched (so with the plan's rows per core
    call) forced to the fused family and to the K-split one at 2, 4 and 8
    blocks per row, and 16 where fb_plan weighs it (K_pad / 16 at least
    _MIN_K_PER_SPLIT), on random GLs, and what fb_plan chooses there."""
    import torch
    from quilt_tpu_torch.kernels import fb as fbk

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    forced = {"fused": dict(family="fused")}
    forced.update({f"tiled/{s}": dict(family="tiled", splits=s) for s in fbk._SPLITS[1:]
                   if s < 16 or fb.K_pad // s >= fbk._MIN_K_PER_SPLIT})
    for B in rows_list:
        gl, _ = _random_dl(fb, B, gen)
        t = {name: _median_ms(lambda: fbk.fb_full_batched(gl, fb, 8, 0.001, **kw), 3)
             for name, kw in forced.items()}
        plan = fbk.fb_plan(B, fb)
        print(f"fb_plan timing, {B} rows x K={fb.K}: " + ", ".join(f"{k} {v:.2f} ms" for k, v in t.items())
              + f"; fb_plan -> {plan[0]}, {plan[1]} rows per call, {plan[2]} blocks per row", flush=True)


# ---------------------------------------------------------------------------
# the full-width world (phase 3 imputes it; phase 2 takes its shapes)
# ---------------------------------------------------------------------------

def e2e_config(n_samples, quilt2=False, nipt=False, ksubset=600):
    """QUILT1 defaults at the quick-start scale: 7 chains x 3 seek
    iterations x 21 sweeps, Ksubset (and Knew) 600, all samples in one
    batch; quilt2 adds the QUILT2 defaults use_mspbwt and
    impute_rare_common; nipt makes it the NIPT method (batches then form
    within equal fetal fractions)."""
    from quilt_tpu_torch.engine.driver import ImputeConfig

    return ImputeConfig(
        nGibbsSamples=7, n_seek_its=3, Ksubset=ksubset, Knew=ksubset,
        small_ref_panel_gibbs_iterations=20, seed=1, sample_batch=n_samples,
        override_default_params_for_small_ref_panel=False,
        print_extra_timing_information=True, verbose=False,
        use_mspbwt=quilt2, impute_rare_common=quilt2,
        method="nipt" if nipt else "diploid",
    )


def make_world(n_samples=8, K=5120, nSNPs=16384, quilt2=False, ffs=None, coverage=1.0,
               hot_map=False, read_length_bp=600, phred=25):
    """A full-width world (K = 5,120 for the QUILT1 / QUILT2 / NIPT phases,
    40,960 for the large-panel phase); quilt2 rewrites 10% of the sites to
    1-4 carriers and prepares the panel as `prepare2` does; ffs makes the
    samples NIPT ones at these fetal fractions; hot_map prepares the panel
    with a genetic map of hotspots (simulate.hot_genetic_map); the reads
    are read_length_bp long at base quality phred (ONT: 6,000 at 10)."""
    import numpy as np
    from quilt_tpu_torch.inputs import region_tensors
    from quilt_tpu_torch.simulate import make_world as simulate

    t = time.time()
    world = simulate(np.random.default_rng(SEED), K=K, nSNPs=nSNPs, n_samples=n_samples,
                     rare_frac=0.1 if quilt2 else 0.0, quilt2=quilt2, ffs=ffs,
                     coverage=coverage, hot_map=hot_map, read_length_bp=read_length_bp,
                     phred=phred)
    world["ffs"] = ffs
    prep = world["prep"]
    W = max(int(np.bincount(r.wif0, minlength=r.wif0.max() + 1).max())
            for r in world["samples"])
    world.update(nGrids=prep.nGrids, max_reads_per_grid=W)
    if not quilt2 and ffs is None:
        world["fb"] = region_tensors(prep, e2e_config(n_samples), "cuda")["fb"]
    rare = "" if not quilt2 else (
        f", {int((~prep.snp_is_common).sum())} rare sites held out of "
        f"{prep.nGrids} common grids, {len(prep.ms_indices)} msPBWT indices")
    if hot_map:
        rare += ", hot genetic map"
    if ffs is not None:
        rare += f", NIPT at fetal fractions {sorted(set(float(f) for f in ffs))}, {coverage}x"
    print(f"world: K={K}, nSNPs={nSNPs}, nGrids={prep.nGrids}{rare}, {n_samples} samples, "
          f"{sum(r.nReads for r in world['samples'])} reads, max reads/grid {W} "
          f"({time.time() - t:.1f} s to simulate and prepare)", flush=True)
    return world


# ---------------------------------------------------------------------------
# phases 3 and 4: full-width end-to-end imputation through the port's engine
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _slot_stats():
    """Counts, over the forward sweeps launched inside the block, the slots
    under the per-grid maximum of the batch (cnt_max[g] for each chain: what
    a kernel vectorised over the chains walks) and the live ones among them
    (a real, informative read). It reads the sweep's arguments on the host,
    so it wraps the warm-up call only."""
    from quilt_tpu_torch.kernels import gibbs

    stats = {"walked": 0, "live": 0}
    real = gibbs.fwd_sweep

    def counting(lemg, beta, lem_pad, slots, first_read, lab_init, trans, cnt_max, **kw):
        if int(cnt_max.sum()):       # not the read-free re-run of a NIPT block move
            stats["walked"] += int(cnt_max.sum()) * slots.shape[3]
            stats["live"] += int((slots[:, 2] == 0).sum())
        return real(lemg, beta, lem_pad, slots, first_read, lab_init, trans, cnt_max, **kw)

    gibbs.fwd_sweep = counting
    try:
        yield stats
    finally:
        gibbs.fwd_sweep = real


def run_e2e(world, kernels, cfg, label, probe=contextlib.nullcontext, block_move=False,
            devices=None):
    """A warm-up call (it builds the region context, cached on the prepared
    reference), then a timed call with every launch count set to 0 just
    before it (the FB plans it took printed, with the K-split forms), then
    one more call under torch.profiler after the counts are read. Returns (output, truth, {kernel name: launches}). In a NIPT
    world the truth and the r2 of the report are the mother's (haplotypes
    1 + 2); nipt_report gives the fetus's. probe() is a context manager
    around the warm-up call too; block_move as profile_call takes it;
    devices the mesh's devices (a config with mesh_data / mesh_panel)."""
    import numpy as np
    import torch
    from quilt_tpu_torch.engine import driver
    from quilt_tpu_torch.kernels import fb as fbk

    samples = world["samples"]
    names = [f"S{i}" for i in range(len(samples))]
    truth_gen = np.stack([t[:2].sum(axis=0) for t in world["truths"]], axis=1).astype(float)
    quilt_impute = lambda *a, **k: driver.quilt_impute(*a, ff_values=world.get("ffs"),
                                                       devices=devices, **k)
    with _slot_stats() as stats, probe():
        quilt_impute(world["prep"], samples, names, cfg, "cuda")
    print(f"{label}: over the call's forward sweeps, {stats['live']} live read slots of the "
          f"{stats['walked']} under the per-grid maximum that a chain's block used to walk ({100 * stats['live'] / max(stats['walked'], 1):.1f}% "
          f"live; the rest are empty or uninformative and are no longer a step)", flush=True)
    for k in kernels:
        k.launches = 0
    # the FB plans the timed call takes (fb_full_batched asks fb_plan)
    plans, real_plan = set(), fbk.fb_plan

    def recording(B, fb, *a, **k):
        got = real_plan(B, fb, *a, **k)
        plans.add((B, fb.K_pad, fb.nGrids) + got)
        return got

    fbk.fb_plan = recording
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        out = quilt_impute(world["prep"], samples, names, cfg, "cuda", truth_gen=truth_gen)
        torch.cuda.synchronize()
        dt = time.time() - t
    finally:
        fbk.fb_plan = real_plan
    launches = {k.name: k.launches for k in kernels}
    for B, K_pad, Gp, family, per_call, splits in sorted(plans):
        print(f"{label}: the FB at {B} rows x K_pad {K_pad}: {family}, {per_call} rows a call, "
              f"{splits} blocks a row" + (f"; {tiled_forms(K_pad, splits, Gp)}"
                                          if family == "tiled" else ""), flush=True)
    print(f"{label}: peak device memory of the timed call {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)", flush=True)
    r2 = out.r2_per_sample
    n_out = truth_gen.shape[0]
    finite = all(np.isfinite(res.dosage).all() and res.dosage.shape == (n_out,)
                 and np.isfinite(res.gp).all() for res in out.results)
    print(f"{label}: {len(samples)} samples in {dt:.2f} s = {len(samples) / dt:.3f} samples/s; "
          f"r2 vs truth min {min(r2):.4f} mean {np.mean(r2):.4f} "
          f"({', '.join(f'{x:.4f}' for x in r2)})", flush=True)
    for name, v in out.timing.items():
        print(f"  {name:<20} {v['seconds'] * 1000:10.1f} ms ({v['calls']} calls)")
    print(f"  launches: {launches}", flush=True)
    if not finite:
        _fail(f"{label} produced non-finite or misshapen dosages")
    profile_call(label, lambda: quilt_impute(world["prep"], samples, names, cfg, "cuda"), dt,
                 block_move)
    return out, truth_gen, launches


def profile_call(label, fn, untraced_s, block_move=False):
    """Device busy time, idle share and the largest kernels of one call,
    and past those the cluster and global forms (a wide path's own rows,
    even where they are small).
    Only the card's activity is traced: the busy time sums device events
    alone, and host operator events would only slow the call and the
    summary (key_averages took ~3.5 s a call with them). The tracer still
    slows the host side, so the idle share is given against the traced
    wall time and against the untraced call's. block_move traces the host
    too, with the static block move (gibbs.suffix_pair_composed /
    nipt_block_within) inside a range "gibbs:block_move", and prints the
    device time of the kernels launched inside it, beside the busy time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from quilt_tpu_torch.kernels import gibbs

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if block_move else [])
    moves = ("suffix_pair_composed", "nipt_block_within") if block_move else ()
    real = {name: getattr(gibbs, name) for name in moves}

    def in_range(fn_):
        def wrapped(*a, **k):
            with record_function("gibbs:block_move"):
                return fn_(*a, **k)
        return wrapped

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda")          # the tracer's one-time start-up, kept out of the window
    torch.cuda.synchronize()
    for name in moves:
        setattr(gibbs, name, in_range(real[name]))
    try:
        t = time.time()
        with profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        wall = time.time() - t
    finally:
        for name in moves:
            setattr(gibbs, name, real[name])
    dev_us = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    # device-side events only: a host operator's entry repeats the device
    # time of the kernels it launched, and summing both counts them twice;
    # the range's own device-side entry is a span of the timeline, not a kernel
    averages = prof.key_averages()
    events = sorted(((dev_us(e), e.count, e.key) for e in averages
                     if dev_us(e) > 0 and e.device_type == DeviceType.CUDA
                     and e.key != "gibbs:block_move"), reverse=True)
    busy = sum(us for us, _, _ in events) / 1e6
    if not busy:
        print(f"{label} profile: no device time recorded (not measured)", flush=True)
        return
    print(f"{label} profile: traced wall {wall:.3f} s, device busy {busy:.3f} s, idle share "
          f"{100 * (1 - busy / wall):.1f}% of the traced wall, {100 * (1 - busy / untraced_s):.1f}% "
          f"of the untraced call's {untraced_s:.3f} s", flush=True)
    for i, (us, count, key) in enumerate(events):
        if i < 10 or "_cluster_kernel" in key or "_global_kernel" in key:
            print(f"  {us / 1e3:10.1f} ms {100 * us / 1e6 / busy:5.1f}% {count:6d} x {key[:70]}"
                  f"{' (past the ten largest)' if i >= 10 else ''}", flush=True)
    if block_move:
        # the host range's device time: the kernels launched inside it, summed
        total = lambda e: getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
        ranges = [e for e in averages if e.key == "gibbs:block_move" and e.device_type == DeviceType.CPU]
        us = sum(total(e) for e in ranges)
        calls = sum(e.count for e in ranges)
        if us:
            print(f"{label} profile: gibbs:block_move, the kernels launched in its {calls} host "
                  f"ranges: {us / 1e3:.1f} ms = {100 * us / 1e6 / busy:.1f}% of device busy",
                  flush=True)
        else:
            print(f"{label} profile: gibbs:block_move: no device time recorded (not measured)",
                  flush=True)


def check_launched(label, launches, needed):
    missing = [k.name for k in needed if not launches[k.name]]
    if missing:
        _fail(f"{label}: a kernel of the path never launched: {missing} ({launches})")


def quilt2_report(world, out, truth_gen):
    """r2 over common and over rare sites (all samples pooled: a sample
    carries few rare alleles) and the mean dosage error at rare sites."""
    import numpy as np

    common = world["prep"].snp_is_common
    dos = np.stack([res.dosage for res in out.results], axis=1)
    r2 = lambda m: float(np.corrcoef(dos[m].ravel(), truth_gen[m].ravel())[0, 1] ** 2)
    err_rare = float(np.abs(dos[~common] - truth_gen[~common]).mean())
    print(f"quilt2: r2 over common sites {r2(common):.4f}, over rare sites {r2(~common):.4f} "
          f"({int(truth_gen[~common].sum())} rare alt alleles in truth); "
          f"mean |dosage err| at rare sites {err_rare:.5f}", flush=True)


def nipt_report(label, world, out):
    """Maternal (haplotypes 1 + 2) and fetal (1 + 3) r2 of a NIPT run per
    sample; fails under the bounds of the JAX package's NIPT acceptance
    test (maternal 0.85, fetal 0.5)."""
    import numpy as np
    from quilt_tpu_torch.out.metrics import r2_simple

    r2m = [r2_simple((t[0] + t[1]).astype(float), r.mat_dosage)
           for t, r in zip(world["truths"], out.results)]
    r2f = [r2_simple((t[0] + t[2]).astype(float), r.fet_dosage)
           for t, r in zip(world["truths"], out.results)]
    fmt = lambda v: ", ".join(f"{x:.4f}" for x in v)
    print(f"{label}: fetal fractions {[float(f) for f in world['ffs']]}; maternal r2 min "
          f"{min(r2m):.4f} mean {np.mean(r2m):.4f} ({fmt(r2m)}); fetal r2 min {min(r2f):.4f} "
          f"mean {np.mean(r2f):.4f} ({fmt(r2f)})", flush=True)
    block = sum(v["seconds"] for k, v in out.timing.items() if k in ("gibbs:block_move", "gibbs:hclass"))
    sweep = out.timing.get("gibbs:sweep_kernel", {}).get("seconds", 0.0) \
        + out.timing.get("rare:sweep_kernel", {}).get("seconds", 0.0)
    print(f"{label}: block moves and read classes take {block * 1000:.1f} ms of the "
          f"{sweep * 1000:.1f} ms of the Gibbs calls ({100 * block / max(sweep, 1e-9):.1f}%)",
          flush=True)
    for res in out.results:
        ok = (res.phased_haps.shape[0] == 3 and np.isfinite(res.fet_dosage).all()
              and np.isfinite(res.fet_gp).all())
        if not ok:
            _fail(f"{label} produced misshapen or non-finite fetal outputs")
    if min(r2m) < 0.85 or min(r2f) < 0.5:
        _fail(f"{label}: maternal r2 below 0.85 or fetal r2 below 0.5")


# ---------------------------------------------------------------------------
# phases map and diag: static map boundaries; the per-sample diagnostics
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _swap_stats(swaps, label):
    """Counts into swaps[label], over the block moves inside the block, the
    (chain, block iteration) pairs and those in which the chain took a
    swap: a diploid suffix swap at some boundary, or a NIPT relabelling
    other than the identity in some block. It reads the moves' results on
    the host, so it wraps the warm-up call only."""
    from quilt_tpu_torch.kernels import gibbs

    stats = swaps[label] = {"moves": 0, "swapped": 0}
    parity, bank = gibbs.pair_swap_parity, gibbs.bank_scan

    def counting_parity(*a, **k):
        out = parity(*a, **k)                       # [G, B]
        stats["moves"] += out.shape[1]
        stats["swapped"] += int(out.any(0).sum())
        return out

    def counting_bank(*a, **k):
        chosen, probs = bank(*a, **k)               # [G, B]: 0 is the identity
        stats["moves"] += chosen.shape[1]
        stats["swapped"] += int((chosen != 0).any(0).sum())
        return chosen, probs

    gibbs.pair_swap_parity, gibbs.bank_scan = counting_parity, counting_bank
    try:
        yield
    finally:
        gibbs.pair_swap_parity, gibbs.bank_scan = parity, bank


def _pse(world, out):
    """Per-sample PSE of the phased haplotypes against the truth's first two."""
    from quilt_tpu_torch.out.metrics import calculate_pse

    return [calculate_pse(res.phased_haps[:2].T, t[:2].T)["pse"]
            for res, t in zip(out.results, world["truths"])]


def run_map(world, counted, need, need_nipt):
    """Phase map: QUILT1 then NIPT at block_gibbs_boundary_detection="map"
    on the hot-map world's panel (run_e2e: warm-up, timed call, profile with
    the block move's device time). Returns {path: launches}."""
    import dataclasses

    import numpy as np
    from quilt_tpu_torch.engine import driver

    cfg = dataclasses.replace(e2e_config(8), block_gibbs_boundary_detection="map")
    ctx = driver._region_context(world["prep"], cfg, "cuda")
    nb = 0 if ctx.boundaries is None else len(ctx.boundaries)
    print(f"map: NB = {nb} static boundaries over {world['nGrids']} grids "
          f"(block_u [n_its, {ctx.block_slots()}, 3, B])", flush=True)
    if nb == 0 or ctx.smooth_w is not None:
        _fail(f"map: no static boundaries (NB {nb})")
    swaps = {}
    launches = {}
    out, _, launches["map"] = run_e2e(world, counted, cfg, "map",
                                      lambda: _swap_stats(swaps, "map"), True)
    if min(out.r2_per_sample) < 0.9:
        _fail(f"map r2 against truth below 0.9: {out.r2_per_sample}")
    pse_map = _pse(world, out)
    gamma = driver.quilt_impute(world["prep"], world["samples"],
                                [f"S{i}" for i in range(len(world["samples"]))],
                                e2e_config(8), "cuda")
    pse_gamma = _pse(world, gamma)
    fmt = lambda v: ", ".join(f"{x:.4f}" for x in v)
    print(f"map: PSE mean {np.mean(pse_map):.4f} ({fmt(pse_map)}); the same world under "
          f"'gamma' {np.mean(pse_gamma):.4f} ({fmt(pse_gamma)})", flush=True)
    check_launched("map", launches["map"], need)
    nipt_world = make_world(n_samples=4, ffs=[0.2] * 4, coverage=2.0, hot_map=True)
    ncfg = dataclasses.replace(e2e_config(4, nipt=True), block_gibbs_boundary_detection="map")
    out, _, launches["map_nipt"] = run_e2e(nipt_world, counted, ncfg, "map_nipt",
                                           lambda: _swap_stats(swaps, "map_nipt"), True)
    nipt_report("map_nipt", nipt_world, out)
    check_launched("map_nipt", launches["map_nipt"], need_nipt)
    for label, st in swaps.items():
        share = st["swapped"] / max(st["moves"], 1)
        print(f"{label}: {st['swapped']} of {st['moves']} (chain, block move) pairs took a swap "
              f"({100 * share:.1f}%, warm-up call)", flush=True)
        if not st["swapped"]:
            _fail(f"{label}: no chain took a swap at the static boundaries")
    return launches


_DIAG_OBJECTS = ("read_labels", "per_it_likelihoods", "dosage", "gp", "phased_haps",
                 "seek_dosages", "read_label_usage")


def run_diag(world, counted, need, fb_families):
    """Phase diag: the nine diagnostic options at once on 2 samples of the
    map world, whose panel gets msPBWT indices here (so make_heuristic_plot
    reruns each sample under both msPBWT approaches on the same context),
    through the per-sample engine with truth. The kernels of `need` must
    launch, and every kernel of one of the FB families (fb_plan takes the
    K-split one at a sample's 14 rows and OHD's 2). Returns the launches."""
    import dataclasses
    import gzip
    import tempfile

    import numpy as np
    import torch
    from quilt_tpu_torch.engine import driver
    from quilt_tpu_torch.out.bgzf import bgzf_open
    from quilt_tpu_torch.panel.mspbwt import build_mspbwt_indices

    t = time.time()
    prep = dataclasses.replace(world["prep"], ms_indices=build_mspbwt_indices(
        world["prep"].panel.hapMatcher, 4))
    print(f"diag: 4 msPBWT indices built in {time.time() - t:.1f} s", flush=True)
    samples, truths = world["samples"][:2], world["truths"][:2]
    names = ["S0", "S1"]
    truth_gen = np.stack([t_.sum(0) for t_ in truths], 1).astype(float)
    truth_haps = np.stack([t_.T for t_ in truths], 1).astype(float)
    out_dir = tempfile.mkdtemp(prefix="quilt_diag_")
    npz = os.path.join(out_dir, "objects.npz")
    cfg = dataclasses.replace(
        e2e_config(2), outputdir=out_dir, make_heuristic_plot=True,
        record_read_label_usage=True, record_interim_dosages=True,
        output_read_label_prob=True, RData_objects_to_save=list(_DIAG_OBJECTS),
        output_RData_filename=npz, make_plots=True, plot_per_sample_likelihoods=True,
        addOptimalHapsToVCF=True)
    vcf = os.path.join(out_dir, "diag.vcf.gz")
    for k in counted:
        k.launches = 0
    torch.cuda.synchronize()
    t = time.time()
    out = driver.quilt_impute(prep, samples, names, cfg, "cuda", output_filename=vcf,
                              truth_gen=truth_gen, truth_haps=truth_haps, region_name="chr20")
    torch.cuda.synchronize()
    dt = time.time() - t
    launches = {k.name: k.launches for k in counted}
    print(f"diag: 2 samples with the nine options in {dt:.2f} s (the per-sample engine, the "
          f"heuristic comparison's reruns, OHD, plots' data and the dump); r2 "
          f"{', '.join(f'{x:.4f}' for x in out.r2_per_sample)}", flush=True)
    for name, v in out.timing.items():
        print(f"  {name:<20} {v['seconds'] * 1000:10.1f} ms ({v['calls']} calls)")
    print(f"  launches: {launches}", flush=True)
    check_launched("diag", launches, need)
    if not any(all(launches[k.name] for k in fam) for fam in fb_families):
        _fail(f"diag: no FB family launched in full: {launches}")
    with np.load(npz) as z:
        keys = set(z.files)
        shapes = {k: z[k].shape for k in sorted(keys)}
    missing = sorted(f"{o}_{n}" for o in _DIAG_OBJECTS for n in names if f"{o}_{n}" not in keys)
    print(f"diag: npz objects {shapes}", flush=True)
    if missing:
        _fail(f"diag: the npz lacks {missing}")
    plots = os.path.join(out_dir, "plots")
    data = [f"haps.{n}.chr20.diagnostics.tsv.gz" for n in names] + \
        [f"{p}.{n}.chr20.{e}" for n in names
         for p, e in (("heuristic", "tsv"), ("blockgibbs", "npz"), ("readflips", "npz"))]
    absent = [f for f in data if not os.path.exists(os.path.join(plots, f))]
    if absent:
        _fail(f"diag: the plots' data files {absent} are missing")
    for n in names:
        rows = gzip.open(os.path.join(plots, f"haps.{n}.chr20.diagnostics.tsv.gz"), "rt").read()
        with open(os.path.join(plots, f"heuristic.{n}.chr20.tsv")) as fh:
            traces = sorted({line.split("\t")[0] for line in fh.read().splitlines()[1:]})
        print(f"diag: {n}: {len(rows.splitlines()) - 1} rows of plot data; heuristic traces "
              f"{traces}", flush=True)
    lines = list(bgzf_open(vcf))
    if not any(line.startswith("##FORMAT=<ID=OHD") for line in lines):
        _fail("diag: the VCF declares no OHD field")
    body = [line.rstrip("\n").split("\t") for line in lines if not line.startswith("#")]
    for i, n in enumerate(names):
        ohd = np.array([[float(x) for x in f[9 + i].split(":")[4].split(",")] for f in body])
        r2 = float(np.corrcoef(ohd.sum(1), truth_gen[:, i])[0, 1] ** 2)
        print(f"diag: {n}: OHD over {len(body)} sites, r2 against truth {r2:.4f} (the "
              f"imputed dosage's {out.r2_per_sample[i]:.4f})", flush=True)
        if not np.isfinite(ohd).all() or r2 < 0.9:
            _fail(f"diag: {n}: OHD not finite or r2 {r2:.4f} under 0.9")
    shutil.rmtree(out_dir)
    return launches


# ---------------------------------------------------------------------------
# phase 7: file-based prepare + impute (QUILT1, QUILT2, NIPT) through the port's CLI
# ---------------------------------------------------------------------------

def run_cli():
    import gzip
    import tempfile

    import numpy as np
    from quilt_tpu_torch.simulate import write_bam_world

    small = ["--nGibbsSamples", "3", "--n_seek_its", "2", "--Ksubset", "48", "--Knew", "48",
             "--small_ref_panel_gibbs_iterations", "8", "--verbose", "FALSE"]
    for prepare, impute, extra, n_rare, ff in (
        ("prepare", "impute", [], 0, None),
        ("prepare2", "impute2", ["--rare_af_threshold", "0.03"], 24, None),
        ("prepare", "impute", [], 0, 0.2),
    ):
        with tempfile.TemporaryDirectory() as d:
            vcf, gmap, bamlist, truths, nSNPs = write_bam_world(
                d, np.random.default_rng(SEED), n_rare=n_rare, ff=ff,
                coverage=2.0 if ff is None else 4.0)
            out = os.path.join(d, "out")
            base = [sys.executable, "-m", "quilt_tpu_torch"]
            nipt = []
            if ff is not None:
                fflist = os.path.join(d, "ff.txt")
                with open(fflist, "w") as fh:
                    fh.write("".join(f"{ff}\n" for _ in truths))
                nipt = ["--method", "nipt", "--fflist", fflist]
                impute_label = f"{impute} --method nipt --fflist"
            else:
                impute_label = impute
            for args in (
                [prepare, "--outputdir", out, "--chr", "chr20", "--reference_vcf_file", vcf,
                 "--genetic_map_file", gmap, "--nGen", "100"] + extra,
                [impute, "--outputdir", out, "--chr", "chr20", "--bamlist", bamlist] + small + nipt,
            ):
                res = subprocess.run(base + args, cwd=HERE, capture_output=True, text=True,
                                     timeout=600)
                if res.returncode != 0:
                    _fail(f"CLI {args[0]} exited {res.returncode}:\n{res.stderr[-3000:]}")
            with gzip.open(os.path.join(out, "quilt.chr20.vcf.gz"), "rt") as fh:
                lines = fh.readlines()
        body = [l for l in lines if not l.startswith("#")]
        fmt = body[0].split("\t")[8]
        if nipt and fmt != "GT:MGP:MDS:FGP:FDS":
            _fail(f"CLI {impute_label} wrote FORMAT {fmt}")
        r2 = []
        for i, truth in enumerate(truths):
            # DS, or the mother's MDS: the third field
            ds = np.array([float(l.split("\t")[9 + i].split(":")[2]) for l in body])
            r2.append(float(np.corrcoef(ds, truth[:2].sum(axis=0))[0, 1] ** 2))
        msg = f"cli: {prepare} + {impute_label} wrote {len(body)} of {nSNPs} sites; r2 {r2}"
        if nipt:
            r2f = []
            for i, truth in enumerate(truths):
                fds = np.array([float(l.split("\t")[9 + i].split(":")[4]) for l in body])
                r2f.append(float(np.corrcoef(fds, truth[0] + truth[2])[0, 1] ** 2))
            msg += f" (maternal), fetal r2 {r2f}"
            if min(r2f) < 0.5:
                _fail(f"CLI {impute_label}: fetal r2 below 0.5: {r2f}")
        print(msg, flush=True)
        if len(body) != nSNPs or min(r2) < 0.85:
            _fail(f"CLI {impute_label} VCF is incomplete or inaccurate")

    # a lone sample goes through the per-sample engine, as in the JAX driver
    with tempfile.TemporaryDirectory() as d:
        vcf, gmap, bamlist, truths, nSNPs = write_bam_world(
            d, np.random.default_rng(SEED + 1), n_samples=1)
        out = os.path.join(d, "out")
        for args in (
            ["prepare", "--outputdir", out, "--chr", "chr20", "--reference_vcf_file", vcf,
             "--genetic_map_file", gmap, "--nGen", "100"],
            ["impute", "--outputdir", out, "--chr", "chr20", "--bamlist", bamlist] + small[:-2],
        ):
            res = subprocess.run([sys.executable, "-m", "quilt_tpu_torch"] + args, cwd=HERE,
                                 capture_output=True, text=True, timeout=600)
            if res.returncode != 0:
                _fail(f"CLI {args[0]} (one sample) exited {res.returncode}:\n{res.stderr[-3000:]}")
        with gzip.open(os.path.join(out, "quilt.chr20.vcf.gz"), "rt") as fh:
            body = [l for l in fh if not l.startswith("#")]
        ds = np.array([float(l.split("\t")[9].split(":")[2]) for l in body])
        r2 = float(np.corrcoef(ds, truths[0].sum(axis=0))[0, 1] ** 2)
        per_sample = "Imputing sample 1/1:" in res.stderr and "(batched)" not in res.stderr
        print(f"cli: a lone sample: impute went through the per-sample engine: {per_sample} "
              f"(log: {[l[22:] for l in res.stderr.splitlines() if 'Imputing' in l]}); "
              f"{len(body)} of {nSNPs} sites, r2 {r2:.4f}", flush=True)
        if not per_sample or len(body) != nSNPs or r2 < 0.85:
            _fail("CLI impute of a lone sample missed the per-sample engine or is inaccurate")


# ---------------------------------------------------------------------------
# phase 8: QUILT-HLA at full width through the port's `hla-prepare` and `hla`
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _stage_times(targets, results):
    """Times every call of the functions targets {label: (module, name)}
    (each returns host data, so its device work is done when it returns)
    and keeps impute_one_sample's results in `results`."""
    import importlib

    times = {label: [0.0, 0] for label in targets}
    saved = []
    for label, (mod_name, name) in targets.items():
        mod = importlib.import_module(mod_name)
        real = getattr(mod, name)

        def timed(*a, _real=real, _label=label, **k):
            t = time.time()
            out = _real(*a, **k)
            times[_label][0] += time.time() - t
            times[_label][1] += 1
            if _label == "impute_one_sample":
                results.append(out)
            return out

        setattr(mod, name, timed)
        saved.append((mod, name, real))
    try:
        yield times
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def hla_args(out, w, hla_prep, extra=()):
    """The `hla` verb at the quick-start shape: 7 chains x 3 seek iterations
    x 21 sweeps, Ksubset 600."""
    return ["hla", "--outputdir", out, "--chr", "chr6", "--bamlist", w["bamlist"],
            "--prepared_reference_filename", w["prep_file"],
            "--prepared_hla_reference_filename", hla_prep, "--nGibbsSamples", "7",
            "--n_seek_its", "3", "--Ksubset", "600", "--Knew", "600",
            "--small_ref_panel_gibbs_iterations", "20",
            "--override_default_params_for_small_ref_panel", "FALSE", "--seed", "1", *extra]


def run_hla(kernels, capture_kernels, device="cuda", K=5120, nSNPs=16384, n_samples=4,
            n_alleles=2000):
    """QUILT-HLA at full width: the world of simulate.write_hla_world (K
    panel haplotypes, nSNPs SNPs, a 3,000 bp gene in the middle whose
    panel SNPs are the variant sites of n_alleles simulated alleles, each
    panel haplotype carrying one, Zipf-skewed; n_samples samples at 1x
    plus reads over the gene at 1x) through `hla-prepare` and `hla` of the
    port's CLI in this process, with every launch count set to 0 just
    before `hla`; prints seconds, samples/s, the stage times, launches, a
    profile of one sample's engine call and the share of the true alleles
    typed, combined and from the gammas alone. Fails if a sample has no
    captured gamma or under half the alleles typed (combined)."""
    import tempfile

    import numpy as np
    import torch
    from quilt_tpu_torch import cli
    from quilt_tpu_torch.simulate import write_hla_world

    sync = (lambda: torch.cuda.synchronize()) if device == "cuda" else (lambda: None)
    with tempfile.TemporaryDirectory() as d:
        t = time.time()
        w = write_hla_world(d, np.random.default_rng(SEED + 7), K=K, nSNPs=nSNPs,
                            n_samples=n_samples, n_alleles=n_alleles)
        print(f"hla world: K={K}, nSNPs={nSNPs}, gene {w['gene'].name} "
              f"{w['gene'].start}-{w['gene'].end}, {n_alleles} alleles, {n_samples} samples; "
              f"true alleles {w['alleles']} ({time.time() - t:.1f} s to simulate, prepare and "
              f"write the BAMs)", flush=True)
        hla_prep = os.path.join(d, "hla_prep.npz")
        t = time.time()
        if cli.main(["hla-prepare", "--hla_db", w["db_file"], "--prepared_reference_filename",
                     w["prep_file"], "--output_file", hla_prep]) != 0:
            _fail("hla-prepare failed")
        t_prep = time.time() - t
        out = os.path.join(d, "out")
        targets = {
            "load_bam_reads": ("quilt_tpu_torch.io.bam", "load_bam_reads"),
            "load_bam_sequences": ("quilt_tpu_torch.io.bam", "load_bam_sequences"),
            "impute_one_sample": ("quilt_tpu_torch.engine.sample", "impute_one_sample"),
            "type_hla_sample": ("quilt_tpu_torch.hla.typing", "type_hla_sample"),
            "pair scan (in type_hla_sample)": ("quilt_tpu_torch.hla.typing", "_pair_read_logsum"),
        }
        results = []
        with _stage_times(targets, results) as stages:
            for k in kernels:
                k.launches = 0
            sync()
            t = time.time()
            rc = cli.main(hla_args(out, w, hla_prep, ["--print_extra_timing_information",
                                                       "TRUE"]), device=device)
            sync()
            dt = time.time() - t
        launches = {k.name: k.launches for k in kernels}
        if rc != 0:
            _fail(f"hla exited {rc}")
        print(f"hla: {n_samples} samples in {dt:.2f} s = {n_samples / dt:.3f} samples/s "
              f"(hla-prepare before it: {t_prep:.2f} s)", flush=True)
        for label, (sec, n) in stages.items():
            print(f"  {label:<32} {sec * 1000:10.1f} ms ({n} calls)", flush=True)
        print(f"  launches: {launches}", flush=True)
        check_launched("hla", launches, capture_kernels)
        typed = {}
        for mode in ("combined", "quiltonly"):
            path = os.path.join(out, f"quilt.hla.output.{mode}.topresult.{w['gene'].name}.txt")
            with open(path) as fh:
                rows = [line.rstrip("\n").split("\t") for line in fh][1:]
            hits = 0
            for row, truth in zip(rows, w["alleles"]):
                left = list(truth)
                for a in row[2:4]:
                    if a in left:
                        left.remove(a)
                        hits += 1
            typed[mode] = hits / (2 * n_samples)
            print(f"hla: {mode}: typed {[tuple(r[2:4]) for r in rows]}; {hits} of "
                  f"{2 * n_samples} true alleles = {100 * typed[mode]:.1f}%", flush=True)
        for i, res in enumerate(results):
            g = res.hla_gamma_total
            if g is None or not np.isfinite(g).all() or abs(g.sum() - 14.0) > 1e-3:
                _fail(f"hla: sample {i} has no captured gamma (or a malformed one)")
        if len(results) != n_samples:
            _fail(f"hla: {len(results)} engine calls for {n_samples} samples")
        if typed["combined"] < 0.5:
            _fail(f"hla: {100 * typed['combined']:.1f}% of the true alleles typed (combined)")
        profile_hla_sample(w, device, dt / n_samples)
    return launches


def profile_hla_sample(w, device, per_sample_s):
    """One sample's per-sample engine call with the HLA capture, timed and
    then profiled (the hla call's own profile would trace the typing's
    host work too)."""
    from quilt_tpu_torch.config import ImputeConfig
    from quilt_tpu_torch.engine.context import RegionContext
    from quilt_tpu_torch.engine.sample import impute_one_sample
    from quilt_tpu_torch.io.bam import load_bam_reads
    from quilt_tpu_torch.panel.prepare import PreparedReference

    prep = PreparedReference.load(w["prep_file"])
    cfg = ImputeConfig(nGibbsSamples=7, n_seek_its=3, Ksubset=600, Knew=600,
                       small_ref_panel_gibbs_iterations=20,
                       override_default_params_for_small_ref_panel=False, verbose=False,
                       hla_run=True, gamma_physically_closest_to=(w["gene"].start + w["gene"].end) // 2)
    ctx = RegionContext.build(prep, cfg, device)
    with open(w["bamlist"]) as fh:
        bam = fh.readline().strip()
    reads = load_bam_reads(bam, prep.chrom, prep.pos, prep.ref_allele, prep.alt_allele, prep.grid)
    impute_one_sample(ctx, reads, cfg, seed=1)
    t = time.time()
    impute_one_sample(ctx, reads, cfg, seed=1)
    dt = time.time() - t
    print(f"hla: one sample's engine call {dt:.3f} s (of {per_sample_s:.3f} s a sample in the "
          f"hla call)", flush=True)
    if device == "cuda":
        profile_call("hla (one sample's engine call)",
                     lambda: impute_one_sample(ctx, reads, cfg, seed=1), dt)


# ---------------------------------------------------------------------------
# phase dist: the device mesh, the panel-sharded FB and multi-host shards
# ---------------------------------------------------------------------------

# segments where the segment kernels are held against their plain versions
# (of the 64 of 512 grids): the first two, a middle one (also timed) and the
# last
SEG_CHECKS = (0, 1, 31, 63)
SEG_TIMED = 31
# the path's segment kernels: the first segment's forward local pass and
# the last one's backward local pass once a call, a step a segment in each
# direction
SEG_NAMES = ("seg_fwd_local", "seg_fwd_step", "seg_bwd_local", "seg_bwd_step")
# the previous form's passes that each step replaces (timed in turn)
SEG_PAIRS = {"seg_fwd_step": ("seg_fwd_apply", "seg_fwd_local"),
             "seg_bwd_step": ("seg_bwd_apply", "seg_bwd_local")}


def _seg_work(name, B, KS, nt, K_top):
    """(bytes, float32 operations) of one launch of a segment kernel on one
    shard of K_shard = KS haplotypes (all real), as the function needs them:
    its inputs read once (the panel words, log-ratios and maxima of the
    grids it touches: 8, 9 in the backward, 16 in a forward step, 17 in a
    backward step; the [B, KS] planes it reads) and its outputs written once.
    Operations per (row, haplotype): an emission logit, its exp and its stay
    product ~10 a grid, then the forward local pass's 28 products, 8 h terms
    and 44 sums (160); the apply's 28 products, 80 of the reconstruction and
    8 divisions (196); the backward local pass's 56 products, 16 q terms
    and 46 sums (~217 with 9 grids' emissions); the backward apply's 28
    products, 64 of the reconstruction, 8 gamma products, 8 normaliser and
    256 bit-masked dosage sums (~460). A forward step is an apply and a
    local pass (356); a backward step an apply, the alphas' rebuild (28
    products, 80 and 8 divisions: 116) and a local pass less the emission it
    shares (~776). Top-K at the thinned grids is left out (a few grids of
    the segment)."""
    L, f = 8, 4
    words, dl, mx, plane = L * KS * f, B * L * 32 * f, B * L * f, B * KS * f
    seg = words + dl + mx                                    # a segment's grids
    nine, tvp = 9 / 8, nt * B * L * 32 * f + nt * L * B * f + 2 * nt * L * B * K_top * f
    work = {
        "seg_fwd_local": (seg + plane + B * nt * 44 * f, 160),
        "seg_fwd_apply": (seg + plane + B * 44 * f + L * plane, 196),
        "seg_fwd_step": (2 * seg + 2 * plane + B * 44 * f + B * 16 * f + B * nt * 44 * f, 356),
        "seg_bwd_local": (nine * seg + plane + B * nt * 46 * f, 217),
        "seg_bwd_apply": (nine * seg + L * plane + 2 * plane + B * 46 * f + tvp, 460),
        "seg_bwd_step": ((2 + 1 / 8) * seg + 3 * plane + B * 46 * f + B * 16 * f + tvp
                         + B * nt * 46 * f, 776),
    }[name]
    return work[0], work[1] * B * KS


def _close(got, ref, rtol=1e-4, per_col=False):
    """(max |got - ref|, within rtol of ref elementwise plus rtol / 100 of
    the largest |ref| (of each last-axis column with per_col))."""
    import torch

    ref, got = ref.double(), got.double()
    dims = tuple(range(ref.dim() - 1))
    scale = ref.abs().amax(dim=dims, keepdim=True) if per_col and dims else ref.abs().max()
    ok = bool(((got - ref).abs() <= rtol * ref.abs() + 1e-2 * rtol * scale).all())
    return (got - ref).abs().max().item(), ok and torch.isfinite(got).all().item()


@contextlib.contextmanager
def _seg_probe(res, segs=SEG_CHECKS, timed_seg=SEG_TIMED):
    """Holds the panel-sharded FB's kernels against their plain versions on
    the path's own inputs. Inside the block every call that
    kernels.fb_sharded.sharded_core makes of fb_max_tiled and of the four
    segment wrappers launches its kernel as usual; the first time a shard
    (its words tensor) at a row count reaches fb_max_tiled, a local pass
    (once a call), or a step at a segment of `segs` (seg_bwd_step also at
    the capture grid's segment), the same inputs go through the plain
    version and through a second launch, the steps on copies of their state
    taken before the path's launch (the second launch also writes the
    segment's alphas: the forward's, and the backward's rebuilt ones, which
    must equal the forward's bit for bit). fb_max_tiled is held within
    max_tiled_tolerance, the segment kernels within rtol 1e-4 plus 1e-6 of
    the largest value (of each value column for the local sums) with the
    top-K haplotypes equal where the values are firm, and the second launch
    must give the path's bits. At segment timed_seg the first shard's steps
    are timed in turn (device time, _alternating_device_ms: 4 rounds of 10
    launches on the copies) with the previous form's apply pass and local
    pass they replace, the local passes where the path launches them, and
    each once with its plain version (_timed). Fills res {name: record} for
    _seg_report. The launches it adds are not the main path's: run_e2e
    wraps the warm-up call, before the counts are set to 0."""
    import torch
    from quilt_tpu_torch.kernels import fb as fbk
    from quilt_tpu_torch.kernels import fb_sharded as fs

    L = fs.SEG_LEN
    names = ("fb_max_tiled",) + SEG_NAMES
    real = {n: getattr(fs, n) for n in names}
    plain = {n: getattr(fs, n + "_plain") for n in SEG_NAMES}
    plain["fb_max_tiled"] = fbk.fb_max_tiled_plain
    for n in names:
        res.setdefault(n, dict(err=0.0, ok=True, same=True, checks=0, ms=None, plain_ms=None,
                               prev_ms=None, timer=None, shape=None, rebuilt=0, rebuilt_same=True))
    seen, fwd_alphas = set(), {}

    def due(name, dl, words, c, extra=False):
        key = (name, words.data_ptr(), dl.shape[0], c)
        if key in seen or not (c in segs or extra):
            return False
        seen.add(key)
        res[name]["checks"] += 1
        return True

    def note(name, got, ref, again, per_col=False, err_ok=None):
        err, ok = _close(got, ref, per_col=per_col) if err_ok is None else err_ok
        r = res[name]
        r["err"], r["ok"] = max(r["err"], err), r["ok"] and ok
        r["same"] = r["same"] and torch.equal(got, again)

    def timing(name, c, dl, words, K_top, fns, plain_fn):
        """fns {"step": ..., apply: ..., local: ...}: timed in turn."""
        r = res[name]
        if c == timed_seg and r["ms"] is None:
            t = _alternating_device_ms(fns)
            r["ms"] = t.pop("step")
            r["prev_ms"], r["timer"] = t, DEVICE_TIMER[0]
            r["plain_ms"] = _timed(plain_fn)[1]
            r["shape"] = (dl.shape[0], words.shape[1], words.shape[0], K_top, c)

    def max_tiled(dl, words, K, k_tile, **kw):
        mx = real["fb_max_tiled"](dl, words, K, k_tile, **kw)
        if due("fb_max_tiled", dl, words, 0, True):
            ref = plain["fb_max_tiled"](dl, words, K, k_tile)
            d = (mx - ref).abs()
            ok = bool((d <= fbk.max_tiled_tolerance(dl, words.shape[0])).all())
            note("fb_max_tiled", mx, ref, real["fb_max_tiled"](dl, words, K, k_tile, **kw),
                 err_ok=(d.max().item(), ok))
        return mx

    def local(name):
        def run(dl, words, trans2, mx, state, c, K_loc):
            part = real[name](dl, words, trans2, mx, state, c, K_loc)
            if due(name, dl, words, c, True):
                again = lambda: real[name](dl, words, trans2, mx, state, c, K_loc)
                ref = plain[name](dl, words, trans2, mx, state, c, K_loc)
                note(name, part, ref, again(), per_col=True)
                r = res[name]
                if timed_seg >= 0 and r["ms"] is None:
                    # launched once a call: timed where the path launches it
                    r["ms"], r["prev_ms"] = _device_ms(again, 10), {}
                    r["timer"] = DEVICE_TIMER[0]
                    r["plain_ms"] = _timed(lambda: plain[name](dl, words, trans2, mx, state, c,
                                                               K_loc))[1]
                    r["shape"] = (dl.shape[0], words.shape[1], words.shape[0], 0, c)
            return part
        return run

    def fwd_step(dl, words, trans2, mx, tot, ckpt, scal, logm, c, K_loc, K):
        name = "seg_fwd_step"
        check = due(name, dl, words, c)
        if check:
            copies = [(ckpt.clone(), scal.clone(), None if logm is None else logm.clone(),
                       torch.empty((L,) + ckpt.shape[1:], dtype=torch.float32, device=ckpt.device))
                      for _ in range(2)]
        part = real[name](dl, words, trans2, mx, tot, ckpt, scal, logm, c, K_loc, K)
        if check:
            (ck1, sc1, lm1, a1), (ck2, sc2, lm2, a2) = copies
            ref = plain[name](dl, words, trans2, mx, tot, ck1, sc1, lm1, c, K_loc, K, a1)
            again = real[name](dl, words, trans2, mx, tot, ck2, sc2, lm2, c, K_loc, K,
                               _alphas=a2)
            note(name, ckpt[c], ck1[c], ck2[c])
            note(name, scal[c], sc1[c], sc2[c])
            note(name, a2, a1, a2)
            if logm is not None:
                note(name, logm[c], lm1[c], lm2[c])
            if part is not None:
                note(name, part, ref, again, per_col=True)
            fwd_alphas[(words.data_ptr(), dl.shape[0], c)] = a2
            if part is not None:
                a0 = ck2[c - 1] if c else None
                seg = torch.empty_like(a2)
                fns = {"step": lambda: real[name](dl, words, trans2, mx, tot, ck2, sc2, lm2, c,
                                                  K_loc, K),
                       "seg_fwd_apply": lambda: fs.seg_fwd_apply(dl, words, trans2, mx, tot, a0,
                                                                 seg, lm2, c, K_loc, K),
                       "seg_fwd_local": lambda: real["seg_fwd_local"](dl, words, trans2, mx,
                                                                      ck2[c], c + 1, K_loc)}
                timing(name, c, dl, words, 0, fns,
                       lambda: plain[name](dl, words, trans2, mx, tot, ck1, sc1, lm1, c, K_loc,
                                           K))
        return part

    def bwd_step(dl, words, trans2, mx, ckpt, scal, tot, thin, beta, out, c, K_loc, K, k0,
                 cap_grid):
        name = "seg_bwd_step"
        check = due(name, dl, words, c, cap_grid >= 0 and cap_grid // L == c)
        if check:
            copies = [(beta.clone(), {k: None if v is None else v.clone() for k, v in out.items()},
                       torch.empty((L,) + beta.shape, dtype=torch.float32, device=beta.device))
                      for _ in range(2)]
        args = lambda b, o: (dl, words, trans2, mx, ckpt, scal, tot, thin, b, o, c, K_loc, K, k0,
                             cap_grid)
        part = real[name](*args(beta, out))
        if check:
            (b1, o1, a1), (b2, o2, a2) = copies
            ref = plain[name](*args(b1, o1), a1)
            again = real[name](*args(b2, o2), _alphas=a2)
            g = slice(c * L, (c + 1) * L)

            def views(b, o):
                v = [b, o["dpart"][:, :, g.start * 32:g.stop * 32], o["gnp"][:, g], o["tvp"][:, g]]
                return v + ([o["gcap"]] if o["gcap"] is not None else [])

            for got, r_, ag in zip(views(beta, out), views(b1, o1), views(b2, o2)):
                note(name, got, r_, ag)
            note(name, a2, a1, a2)
            if part is not None:
                note(name, part, ref, again, per_col=True)
            tv_r, ti_r, ti_k = o1["tvp"][:, g], o1["tip"][:, g], out["tip"][:, g]
            firm = (tv_r[..., :-1] - tv_r[..., 1:]) > 1e-4 * tv_r.abs().max()
            r = res[name]
            r["ok"] = r["ok"] and torch.equal(ti_k[..., :-1][firm], ti_r[..., :-1][firm])
            r["same"] = r["same"] and torch.equal(ti_k, o2["tip"][:, g])
            fwd = fwd_alphas.get((words.data_ptr(), dl.shape[0], c))
            if fwd is not None:
                r["rebuilt"] += 1
                r["rebuilt_same"] = r["rebuilt_same"] and torch.equal(a2, fwd)
            if part is not None:
                fns = {"step": lambda: real[name](*args(b2, o2)),
                       "seg_bwd_apply": lambda: fs.seg_bwd_apply(dl, words, trans2, mx, a2, tot,
                                                                 thin, b2, o2, c, K_loc, K, k0,
                                                                 cap_grid),
                       "seg_bwd_local": lambda: real["seg_bwd_local"](dl, words, trans2, mx, b2,
                                                                      c - 1, K_loc)}
                timing(name, c, dl, words, out["tvp"].shape[3], fns,
                       lambda: plain[name](*args(b1, o1)))
        return part

    patched = {"fb_max_tiled": max_tiled, "seg_fwd_local": local("seg_fwd_local"),
               "seg_fwd_step": fwd_step, "seg_bwd_local": local("seg_bwd_local"),
               "seg_bwd_step": bwd_step}
    for n in names:
        setattr(fs, n, patched[n])
    try:
        yield res
    finally:
        for n in names:
            setattr(fs, n, real[n])


def _seg_report(label, res):
    """Prints _seg_probe's records and fails if a kernel went unchecked,
    disagreed with its plain version, gave other bits a second time, or
    (the backward step) rebuilt other alphas than the forward's. Returns
    {segment step: (max abs error, ms, plain ms, bytes, operations, {the
    replaced pass: ms in turn})}, at the timed segment's shape."""
    from quilt_tpu_torch.kernels import fb_sharded as fs

    out = {}
    for name, r in res.items():
        tol = ("max_tiled_tolerance" if name == "fb_max_tiled" else
               "rtol 1e-4 + 1e-6 of the largest" + ("; top-K haplotypes equal where firm"
                                                    if name == "seg_bwd_step" else ""))
        line = (f"{label}: {name}: max |err| {r['err']:.3e} over {r['checks']} checked launches "
                f"on the path's inputs (tolerance {tol}), {'ok' if r['ok'] else 'FAILS'}; two launches "
                f"{'equal bit for bit' if r['same'] else 'DIFFER'}")
        if name == "seg_bwd_step":
            line += (f"; rebuilt alphas {'equal' if r['rebuilt_same'] else 'DIFFER from'} the "
                     f"forward's bit for bit at {r['rebuilt']} checked segments")
        if r["ms"] is not None:
            B, KS, Gp, K_top, c = r["shape"]
            nbytes, ops = _seg_work(name, B, KS, fs.n_tiles(KS), K_top)
            bound = _bound(nbytes, ops)
            prev = " + ".join(f"{k} {v:.4f}" for k, v in r["prev_ms"].items())
            line += (f"; at {B} rows x K_shard {KS}, {Gp} grids, segment {c}: kernel "
                     f"{r['ms']:.4f} ms of device time ({r['timer']})" + (f" against the previous form's {prev} = "
                                           f"{sum(r['prev_ms'].values()):.4f} ms, in turn"
                                           if prev else "")
                     + f"; plain {r['plain_ms']:.1f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
            out[name] = (r["err"], r["ms"], r["plain_ms"], nbytes, ops, r["prev_ms"])
        print(line, flush=True)
        if (not r["checks"] or not r["ok"] or not r["same"] or not r["rebuilt_same"]
                or (name == "seg_bwd_step" and not r["rebuilt"])):
            _fail(f"{label}: {name} unchecked, or it disagrees with its plain version or "
                  f"between launches, or rebuilt other alphas")
    return out


def _ptxas_note(kernel):
    return "; ".join(PTXAS.get(kernel, [])).replace("<> ", "") or "not in this run's build report"


def seg_step_split(label, B, KS, trans2, K, thin, times, K_top=8, steps=64):
    """The "seg step split" lines at B rows x K_shard KS: each segment
    kernel's device time a grid (from `times`, {kernel: ms a launch} timed
    in turn by _seg_probe) beside the pieces of its work, each timed alone by
    fb_sharded.seg_split in every block of the same launch shape (the
    difference of `steps` and 2 `steps` repetitions, so the launch's own
    cost drops out): the previous backward apply's per-grid pair of block
    reductions, one block_argmax round (K_top of them at each thinned
    grid), thread 0's mass solves, a local pass's block_sums; the
    backward step's reductions of a segment and its top-K of one thinned
    grid; the bytes of the planes each reads or writes; ptxas's registers
    and spills. Returns {piece: us a repetition}."""
    from quilt_tpu_torch.kernels import fb_sharded as fs

    L, nt = fs.SEG_LEN, fs.n_tiles(KS)
    us = {}
    for which, piece in enumerate(fs.SPLIT_PIECES):
        t1 = _median_ms(lambda: fs.seg_split(which, steps, B, KS, K_top, trans2, K), 5)
        t2 = _median_ms(lambda: fs.seg_split(which, 2 * steps, B, KS, K_top, trans2, K), 5)
        us[piece] = max(t2 - t1, 0.0) * 1e3 / steps
    share = float((thin >= 0).float().mean())
    plane_mb = B * KS * 4 / 1e6
    topk = K_top * us["block_argmax round"] * share
    a_grid = lambda name: 1e3 * times[name] / L if name in times else float("nan")
    head = f"seg step split, {label}, {B} rows x K_shard {KS} ({nt * B} blocks of 512) (this run)"
    print(f"{head}: seg_bwd_apply {a_grid('seg_bwd_apply'):.2f} us a grid: its block_reduce + "
          f"block_reduce32 pair {us['bwd apply grid reductions']:.2f} us a grid; a block_argmax "
          f"round {us['block_argmax round']:.2f} us, {K_top} a thinned grid, {100 * share:.1f}% of "
          f"grids thinned: {topk:.2f} us a grid; thread 0's mass solve {us['bwd mass solve']:.2f} "
          f"us a segment; reads 8 alpha planes, {8 * plane_mb:.1f} MB a launch "
          f"({8 * plane_mb * 1e12 / HBM_BYTES_PER_S:.2f} us at the HBM rate); ptxas "
          f"{_ptxas_note('seg_bwd_apply_kernel')}", flush=True)
    print(f"{head}: seg_fwd_apply {a_grid('seg_fwd_apply'):.2f} us a grid: thread 0's mass solve "
          f"{us['fwd mass solve']:.2f} us a segment; writes 8 alpha planes, {8 * plane_mb:.1f} MB "
          f"a launch; ptxas {_ptxas_note('seg_fwd_apply_kernel')}", flush=True)
    for name in ("seg_fwd_local", "seg_bwd_local"):
        print(f"{head}: {name} {a_grid(name):.2f} us a grid: block_sums of 45 values "
              f"{us['block_sums of 45']:.2f} us a segment; reads 1 plane, {plane_mb:.1f} MB; ptxas "
              f"{_ptxas_note(name + '_kernel')}", flush=True)
    print(f"{head}: seg_bwd_step {a_grid('seg_bwd_step'):.2f} us a grid: the segment's "
          f"reductions (8 grids x 33 sums and 45 local sums, transposing, one barrier) "
          f"{us['bwd step segment reductions']:.2f} us a segment = "
          f"{us['bwd step segment reductions'] / L:.2f} us a grid; top-K of a thinned grid (per "
          f"warp, then one merge) {us['bwd step top-K of a grid']:.2f} us, "
          f"{us['bwd step top-K of a grid'] * share:.2f} us a grid; mass solve "
          f"{us['bwd mass solve']:.2f} us a segment; reads 1 checkpoint plane and the carry, "
          f"writes the carry, {3 * plane_mb:.1f} MB; ptxas {_ptxas_note('seg_bwd_step_kernel')}",
          flush=True)
    print(f"{head}: seg_fwd_step {a_grid('seg_fwd_step'):.2f} us a grid: mass solve "
          f"{us['fwd mass solve']:.2f} us a segment; reads 1 checkpoint plane, writes 1, "
          f"{2 * plane_mb:.1f} MB; ptxas {_ptxas_note('seg_fwd_step_kernel')}", flush=True)
    return us


def _step_times(res):
    """{kernel: ms a launch} of _seg_probe's timed steps and the passes they
    replaced, in turn."""
    t = {}
    for name in ("seg_fwd_step", "seg_bwd_step"):
        r = res.get(name, {})
        if r.get("ms") is not None:
            t[name] = r["ms"]
            t.update(r["prev_ms"])
    return t


def _peak_gib(fn):
    """(fn(), its peak device memory in GiB over what was allocated before
    it, the absolute peak in GiB)."""
    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return out, (peak - before) / 2**30, peak / 2**30


def _sharded_prev(sfb):
    """A ShardedFB-like callable running sharded_core's previous form
    (_prev=True) on sfb's shards: the one data row's call, for timings."""
    from quilt_tpu_torch.kernels import fb_sharded as fs

    (group, shards), = sfb.rows
    inp = sfb.inputs
    return lambda gl: fs.sharded_core(gl, shards, group, inp.K, sfb.K_top, sfb.ref_error,
                                      inp.capture_grid, _prev=True)


def check_sharded_fb(fb, B=112, K_top=8, eps=0.001):
    """fb_full_sharded over make_mesh(1, n, [cuda:0] x n), n = 2, 3 and 4
    (K = 5,120 in 3 shards leaves the last 1,536 real haplotypes of its
    1,792 columns), against fb_full_batched on the card at B random rows:
    dosage and log-likelihood errors, the top-K haplotypes shared at the
    thinned grids, two calls equal bit for bit; the gamma captured at the
    middle grid at 14 rows. The first call and the capture call run under
    _seg_probe, which holds fb_max_tiled and the segment kernels against
    their plain versions on every shard. Times the sharded call (median of
    3) in turn with sharded_core's previous form, each with its peak device
    memory, and one exchange of a segment's [B, 46] sums (median of 20),
    with the exchanges a call makes. On one card the shards run one after
    another: these are not multi-card figures. Returns {n: the probe's
    records}."""
    import dataclasses

    import torch
    from quilt_tpu_torch.dist.mesh import ShardedFB, make_mesh
    from quilt_tpu_torch.kernels import fb as fbk

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 4)
    gl = _random_dl(fb, B, gen, eps)[0]
    ref = fbk.fb_full_batched(gl, fb, K_top, eps)
    t_ref = _median_ms(lambda: fbk.fb_full_batched(gl, fb, K_top, eps), 3)
    fb_cap = dataclasses.replace(fb, capture_grid=fb.nGrids // 2)
    gl14 = gl[:14].contiguous()
    ref_cap = fbk.fb_full_batched(gl14, fb_cap, K_top, eps)
    thin = torch.as_tensor(fb.thin_flag >= 0, device=dev)
    probes = {}
    for n in (2, 3, 4):
        mesh = make_mesh(1, n, [dev] * n)
        sfb = ShardedFB(fb, mesh, K_top=K_top, ref_error=eps)
        sfb_cap = ShardedFB(fb_cap, mesh, K_top=K_top, ref_error=eps)
        with _seg_probe(probes.setdefault(n, {})):
            out = sfb(gl)
            cap = sfb_cap(gl14)
        again = sfb(gl)
        same = all(torch.equal(a, b) for a, b in zip(out, again))
        err_d = (out[0] - ref[0][:, :fb.nSNPs]).abs().max().item()
        err_l = ((out[1] - ref[1]).abs() / ref[1].abs()).max().item()
        ti, ti_r = out[3][thin][:, :, :K_top], ref[3][thin]
        shared = (ti[..., :, None] == ti_r[..., None, :]).any(-1).sum(-1).min().item()
        err_tv = (out[2][thin][:, :, :K_top] - ref[2][thin]).abs().max().item()
        group = sfb.rows[0][0]
        e0 = group.exchanges
        prev = _sharded_prev(sfb)
        t = _alternating_ms({"new": lambda: sfb(gl), "previous form": lambda: prev(gl)},
                            rounds=2, n=3)
        per_call = (group.exchanges - e0) // 12
        mem = {k: _peak_gib(lambda: f(gl))[1:] for k, f in (("new", sfb), ("previous", prev))}
        parts = [torch.rand((B, 46), generator=gen, device="cuda") for _ in range(n)]
        ex_ms = _median_ms(lambda: group.sum(parts), 20)
        err_cap = (cap[4] - ref_cap[4]).abs().max().item()
        print(f"sharded FB, {n} shards of K={fb.K} (K_shard {sfb.K_shard}) on one card, {B} rows "
              f"x {fb.nGrids} grids: "
              f"dosage max |err| {err_d:.3e} (tolerance 1e-4), log-likelihood rel err "
              f"{err_l:.3e} (1e-5), top-K values {err_tv:.3e} (1e-4), at least {shared} of "
              f"{K_top} haplotypes shared at every thinned grid (7), capture at 14 rows "
              f"{err_cap:.3e} (1e-5); two calls {'equal bit for bit' if same else 'DIFFER'}; "
              f"{t['new']:.2f} ms a call against the previous form's {t['previous form']:.2f}, in "
              f"turn, and {t_ref:.2f} ms unsharded; peak device memory of a call "
              f"{mem['new'][0]:.3f} GiB above what it found ({mem['new'][1]:.2f} GiB in all) "
              f"against the previous form's {mem['previous'][0]:.3f} ({mem['previous'][1]:.2f}); "
              f"{per_call} exchanges a call; {ex_ms:.4f} ms an exchange of [{B}, 46] sums; one "
              f"card: the shards run in turn, not a multi-card figure", flush=True)
        if (err_d > 1e-4 or err_l > 1e-5 or err_tv > 1e-4 or shared < 7 or err_cap > 1e-5
                or not same or per_call != 2 * fb.nGrids // 8 + 2):
            _fail(f"the sharded FB over {n} shards disagrees with the unsharded one")
    return probes


def check_sharded_fb_wide(B=84, K=98304, K_top=8, eps=0.001):
    """The sharded FB at k100k's panel size (K = 98,304 x 512 grids, B =
    84 rows: a 6-sample batch) over make_mesh(1, n, [cuda:0] x n), n = 2
    and 4, against the unsharded FB of fb_plan's choice on the same rows
    (the check_sharded_fb tolerances), the first call under _seg_probe at
    segments 0 and 1 only (and the local passes), timed in turn with
    sharded_core's previous form (median of 3, 2 rounds) beside the
    unsharded call, each with its peak device memory. The previous form's
    alpha planes are 8.46 GB a shard at 2 shards. One card: the shards
    run in turn, not a multi-card figure."""
    import torch
    from quilt_tpu_torch.dist.mesh import ShardedFB, make_mesh
    from quilt_tpu_torch.kernels import fb as fbk

    dev = torch.device("cuda", 0)
    fb = synthetic_fb(K)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    gl = _random_dl(fb, B, gen, eps)[0]
    plan = fbk.fb_plan(B, fb)
    ref, m_ref, _ = _peak_gib(lambda: fbk.fb_full_batched(gl, fb, K_top, eps))
    t_ref = _median_ms(lambda: fbk.fb_full_batched(gl, fb, K_top, eps), 3)
    thin = torch.as_tensor(fb.thin_flag >= 0, device=dev)
    for n in (2, 4):
        sfb = ShardedFB(fb, make_mesh(1, n, [dev] * n), K_top=K_top, ref_error=eps)
        probe = {}
        with _seg_probe(probe, segs=(0, 1), timed_seg=-1):
            out = sfb(gl)
        _seg_report(f"sharded FB at K={K}, {n} shards", probe)
        err_d = (out[0] - ref[0][:, :fb.nSNPs]).abs().max().item()
        err_l = ((out[1] - ref[1]).abs() / ref[1].abs()).max().item()
        ti, ti_r = out[3][thin][:, :, :K_top], ref[3][thin]
        shared = (ti[..., :, None] == ti_r[..., None, :]).any(-1).sum(-1).min().item()
        err_tv = (out[2][thin][:, :, :K_top] - ref[2][thin]).abs().max().item()
        del out
        prev = _sharded_prev(sfb)
        t = _alternating_ms({"new": lambda: sfb(gl), "previous form": lambda: prev(gl)},
                            rounds=2, n=3)
        mem = {k: _peak_gib(lambda: f(gl))[1:] for k, f in (("new", sfb), ("previous", prev))}
        print(f"sharded FB at k100k's panel, {n} shards of K={K} (K_shard {sfb.K_shard}) on one "
              f"card, {B} rows x {fb.nGrids} grids: dosage max |err| {err_d:.3e} (1e-4), "
              f"log-likelihood rel err {err_l:.3e} (1e-5), top-K values {err_tv:.3e} (1e-4), at "
              f"least {shared} of {K_top} shared (7); {t['new']:.2f} ms a call against the "
              f"previous form's {t['previous form']:.2f}, in turn; peak device memory of a call "
              f"{mem['new'][0]:.2f} GiB above what it found ({mem['new'][1]:.2f} in all) against "
              f"the previous form's {mem['previous'][0]:.2f} ({mem['previous'][1]:.2f}); the "
              f"unsharded FB ({plan[0]}, {plan[1]} rows a call, {plan[2]} blocks a row) {t_ref:.2f} "
              f"ms, peak {m_ref:.2f} GiB above; one card: the shards run in turn, not a "
              f"multi-card figure", flush=True)
        if err_d > 1e-4 or err_l > 1e-5 or err_tv > 1e-4 or shared < 7:
            _fail(f"the sharded FB at K = {K} over {n} shards disagrees with the unsharded one")
        del sfb, prev
        torch.cuda.empty_cache()


def run_dist_engine(world, counted, single, seg_kernels, fused):
    """The e2e world through quilt_impute at mesh (2, 2) over [cuda:0] x 4
    (run_e2e): every r2 >= 0.9, each sample's DS r2 > 0.98 against the
    single-card run `single`, the segment kernels launched (a step a
    segment, each local pass once a call) and the fused FB not; its
    warm-up call runs under _seg_probe, which holds fb_max_tiled and the
    segment kernels against their plain versions on the path's own inputs
    (each data row's 56 rows on each shard). The same call's peak device
    memory, then with sharded_core's previous form. Then mesh
    (2, 1) over [cuda:0] x 2 against one card, both writing the VCF: the
    same bytes (the FB is the single-card one, the Gibbs chains split into
    independent blocks). Returns (the launches of the (2, 2) call, the
    probe's records)."""
    import dataclasses
    import functools
    import tempfile

    import numpy as np
    import torch
    from quilt_tpu_torch.dist import mesh as dmesh
    from quilt_tpu_torch.engine import driver

    dev = torch.device("cuda", 0)
    cfg = e2e_config(8)
    probe = {}
    cfg22 = dataclasses.replace(cfg, mesh_data=2, mesh_panel=2)
    out, _, launches = run_e2e(world, counted, cfg22, "dist", probe=lambda: _seg_probe(probe),
                               devices=[dev] * 4)
    r2_single = [float(np.corrcoef(a.dosage, b.dosage)[0, 1] ** 2)
                 for a, b in zip(out.results, single.results)]
    print(f"dist: mesh (2, 2) over one card: each sample's DS r2 against the single-card "
          f"run {', '.join(f'{x:.4f}' for x in r2_single)}", flush=True)
    if min(out.r2_per_sample) < 0.9 or min(r2_single) <= 0.98:
        _fail(f"dist: r2 {out.r2_per_sample} or DS r2 against one card {r2_single}")
    check_launched("dist", launches, seg_kernels)
    if any(launches[k.name] for k in fused):
        _fail(f"dist launched the fused FB at mesh_panel 2: {launches}")
    # a step a segment, each local pass once a call
    local, steps = launches["seg_fwd_local"], launches["seg_fwd_step"]
    n_seg = world["fb"].nGrids // 8
    if (launches["seg_bwd_local"] != local
            or not steps == launches["seg_bwd_step"] == n_seg * local):
        _fail(f"dist: not one step a segment and one local pass a call on each shard: {launches}")
    names = [f"S{i}" for i in range(len(world["samples"]))]
    call = lambda: driver.quilt_impute(world["prep"], world["samples"], names, cfg22, "cuda",
                                       devices=[dev] * 4)
    real = dmesh.sharded_core
    peaks = {"new": _peak_gib(call)[1:]}
    dmesh.sharded_core = functools.partial(real, _prev=True)
    try:
        peaks["previous"] = _peak_gib(call)[1:]
    finally:
        dmesh.sharded_core = real
    print(f"dist: peak device memory of the call (torch.cuda.max_memory_allocated), in turn: "
          f"{peaks['new'][0]:.3f} GiB above what it found ({peaks['new'][1]:.3f} in all) against "
          f"{peaks['previous'][0]:.3f} ({peaks['previous'][1]:.3f}) with sharded_core's previous "
          f"form", flush=True)
    with tempfile.TemporaryDirectory() as d:
        paths = [os.path.join(d, f"{m}.vcf.gz") for m in ("one", "data")]
        driver.quilt_impute(world["prep"], world["samples"], names, cfg, "cuda",
                            output_filename=paths[0])
        driver.quilt_impute(world["prep"], world["samples"], names,
                            dataclasses.replace(cfg, mesh_data=2), "cuda",
                            output_filename=paths[1], devices=[dev] * 2)
        same = [open(p, "rb").read() for p in paths]
    print(f"dist: mesh (2, 1) over one card: the VCF is the single-card VCF byte for byte: "
          f"{same[0] == same[1]}", flush=True)
    if same[0] != same[1]:
        _fail("dist: mesh (2, 1) changed the single-card VCF")
    return launches, probe


def run_multihost():
    """The CLI world (4 samples) imputed by one process and by two
    (--distributed_nproc 2, gloo on localhost) on the card: the sample
    columns equal bit for bit, INFO within 1e-3 of |value|, and only rank 0
    writes the VCF (its log says so, rank 1's does not)."""
    import gzip
    import socket
    import tempfile

    import numpy as np
    from quilt_tpu_torch.simulate import write_bam_world

    with tempfile.TemporaryDirectory() as d:
        vcf, gmap, bamlist, _, nSNPs = write_bam_world(d, np.random.default_rng(SEED + 2),
                                                       n_samples=4)
        base = [sys.executable, "-m", "quilt_tpu_torch"]
        res = subprocess.run(base + ["prepare", "--outputdir", d, "--chr", "chr20",
                                     "--reference_vcf_file", vcf, "--genetic_map_file", gmap,
                                     "--nGen", "100"], cwd=HERE, capture_output=True, text=True,
                             timeout=600)
        if res.returncode:
            _fail(f"multihost: prepare exited {res.returncode}:\n{res.stderr[-3000:]}")
        prepared = os.path.join(d, "RData", "QUILT_prepared_reference.chr20.npz")

        def impute(out):
            return base + ["impute", "--outputdir", os.path.join(d, out), "--chr", "chr20",
                           "--bamlist", bamlist, "--prepared_reference_filename", prepared,
                           "--nGibbsSamples", "3", "--n_seek_its", "2", "--Ksubset", "48",
                           "--Knew", "48", "--small_ref_panel_gibbs_iterations", "8",
                           "--sample_batch", "2"]

        t = time.time()
        res = subprocess.run(impute("one"), cwd=HERE, capture_output=True, text=True,
                             timeout=600)
        if res.returncode:
            _fail(f"multihost: one process exited {res.returncode}:\n{res.stderr[-3000:]}")
        t_one = time.time() - t
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        t = time.time()
        procs = [subprocess.Popen(
            impute("two") + ["--distributed_nproc", "2", "--distributed_rank", str(r),
                             "--distributed_coordinator", f"localhost:{port}"],
            cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        try:
            logs = [p.communicate(timeout=600)[1] for p in procs]
        finally:
            for p in procs:
                p.kill()
        t_two = time.time() - t
        for r, p in enumerate(procs):
            if p.returncode:
                _fail(f"multihost: rank {r} exited {p.returncode}:\n{logs[r][-3000:]}")
        bodies = []
        for out in ("one", "two"):
            with gzip.open(os.path.join(d, out, "quilt.chr20.vcf.gz"), "rt") as fh:
                bodies.append([l.rstrip("\n").split("\t") for l in fh if not l.startswith("#")])
    writes = ["Wrote " in log for log in logs]
    same_cols = len(bodies[0]) == len(bodies[1]) == nSNPs and all(
        a[:7] == b[:7] and a[8:] == b[8:] for a, b in zip(*bodies))
    info = 0.0
    for a, b in zip(*bodies):
        for kv1, kv2 in zip(a[7].split(";"), b[7].split(";")):
            v1, v2 = float(kv1.split("=")[1]), float(kv2.split("=")[1])
            info = max(info, abs(v1 - v2) / max(1.0, abs(v1)))
    print(f"multihost: 4 samples, one process {t_one:.1f} s, two processes on the card (gloo) "
          f"{t_two:.1f} s; sample columns equal bit for bit: {same_cols}; INFO max rel diff "
          f"{info:.2e} (1e-3); VCF written by ranks {[r for r, w in enumerate(writes) if w]}",
          flush=True)
    if not same_cols or info >= 1e-3 or writes != [True, False]:
        _fail("multihost: the two-process VCF differs from one process's, or rank 1 wrote")


def run_dist(world, counted, single, seg_kernels, fused):
    """Phase dist: the sharded FB against the unsharded one at 112 rows x K
    = 5,120 split 2, 3 and 4 ways and at 84 rows x K = 98,304 split 2 and 4
    ways, the engine on meshes over the one card (against `single`, the e2e
    phase's output, or a single-card call made here), each with
    fb_max_tiled and the segment kernels held against their plain versions
    on the inputs the calls give them, the "seg step split" lines at the
    dist path's 56 rows and the timing shape's 112, and the CLI as two
    processes. Returns (rows of the kernels line: times at 112 rows x
    K_shard 2,560, errors the largest of every check; the engine's
    launches; fb_max_tiled's largest error on the shards)."""
    if single is None:
        from quilt_tpu_torch.engine import driver

        single = driver.quilt_impute(world["prep"], world["samples"],
                                     [f"S{i}" for i in range(len(world["samples"]))],
                                     e2e_config(8), "cuda")
    fb = world["fb"]
    probes = check_sharded_fb(fb)
    reports = {n: _seg_report(f"sharded FB, {n} shards", r) for n, r in probes.items()}
    check_sharded_fb_wide()
    launches, engine = run_dist_engine(world, counted, single, seg_kernels, fused)
    on_path = _seg_report("dist, mesh (2, 2)", engine)
    dev = fb.device_tensors("cuda")
    for label, res in (("the dist path's shape", engine), ("the timing shape", probes[2])):
        B, KS = res["seg_bwd_step"]["shape"][:2]
        seg_step_split(label, B, KS, dev["trans2"], fb.K, dev["thin_flag"], _step_times(res))
    every = list(probes.values()) + [engine]
    rows = []
    for name in SEG_NAMES:
        _, ms, plain_ms, nbytes, ops, prev = reports[2][name]
        rows.append(_row(name, "fb_sharded.cu", "fb_full.py:440",
                         max(r[name]["err"] for r in every), ms, plain_ms, nbytes, ops))
        rows[-1]["replaces"] += " _fb_core_segmented (XLA, no Pallas kernel)"
        rows[-1]["ms_on_path"] = {"dist": on_path[name][1]}
        if prev:
            rows[-1]["previous_form_ms"] = prev
    run_multihost()
    return rows, launches, max(r["fb_max_tiled"]["err"] for r in every)


# ---------------------------------------------------------------------------
# phase bench: the worlds of the benchmark programs (quilt_tpu_torch/bench)
# ---------------------------------------------------------------------------

def _bench_config(n_samples, **kw):
    """The benchmark's end-to-end config (bench.full.e2e_config) with the
    section timers on, as the other phases run."""
    import dataclasses
    from quilt_tpu_torch.bench import full as bfull

    return dataclasses.replace(bfull.e2e_config(n_samples, **kw),
                               print_extra_timing_information=True, verbose=False)


def _bench_section(name, t):
    print(f"bench section {name}: {time.time() - t:.1f} s", flush=True)
    return time.time()


@contextlib.contextmanager
def _path_probe(label, res, n_fwd=4, n_bwd=3, n_bank=2):
    """Holds the kernels that the engine launches inside the block against
    their plain versions on the arguments the path gives them, as _seg_probe
    does for the sharded FB: gibbs_fwd on the first call of each (it_mode,
    want_alpha, reads or none) it meets, up to n_fwd calls and the first
    read-free one (the NIPT block move's re-run), at _check_fwd's
    tolerances, a second launch giving the same bits; gibbs_bwd on its
    first n_bwd calls at the kernels phase's rtol 1e-5 / atol 1e-6; the
    NIPT block move's bank (bank_scan) on its first n_bank calls, the same
    relabellings on all but PARTED_CHAINS_BOUND of the chains, probabilities
    within atol 1e-4, a second launch giving the same bits; the fused FB
    (fb_core: fb_fwd then fb_bwd) on its first row batch, its dosage,
    log-likelihood and top-K against fb_forward_plain -> fb_backward_plain
    at _check_fused's tolerances. Each check names the form the wrapper
    took, and the sweeps' and the bank's checks time the kernel on the
    call's own inputs (median of 3 launches). The plain versions launch no
    kernel; the second launches and the timed ones are counted, so the
    caller keeps the probed call out of the counted run. res[row name]
    collects the errors (res["forms"] the forms and keys checked, res["ms"]
    {kernel name: [ms on each checked call]}); _probe_report reads them."""
    import torch
    from quilt_tpu_torch.kernels import fb as fbk
    from quilt_tpu_torch.kernels import gibbs
    from quilt_tpu_torch.kernels import gibbs_sweep as gs
    from quilt_tpu_torch.kernels import nipt_bank as nb

    real = (gibbs.fwd_sweep, gibbs.bwd_sweep, fbk.fb_core, gibbs.bank_scan)
    seen = set()
    for name in ("gibbs_fwd", "gibbs_bwd", "fb_fwd", "fb_bwd", "nipt_bank", "forms"):
        res.setdefault(name, [])
    res.setdefault("ms", {})

    def timed(kernel, fn):
        """CUDA events around the wrapper (median of 7), and the wrapper's
        host side alone (median of 3, the card drained before each)."""
        ms = _median_ms(fn, 7)
        host = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        res["ms"].setdefault(kernel.name, []).append(ms)
        return f"{ms:.3f} ms a launch (CUDA events; the wrapper's host side {statistics.median(host):.3f})"

    def fwd(*args, **kw):
        got = real[0](*args, **kw)
        reads = int(args[7].max()) > 0
        key = (kw["it_mode"], kw.get("want_alpha", True), reads)
        if key not in seen and (len(seen) < n_fwd or not reads):
            seen.add(key)
            form = gs.fwd_form(args[0].shape[2], kw["nl"])
            ref = gs.fwd_sweep_plain(*args, K_real=kw["K_real"], it_mode=key[0],
                                     want_alpha=key[1], nl=kw["nl"], prior=kw["prior"])
            kernel = {gs.GLOBAL: gs.FWD_GLOBAL_KERNELS,
                      gs.CLUSTER: gs.FWD_CLUSTER_KERNELS}.get(form, gs.FWD_KERNELS)[kw["nl"]]
            again = real[0](*args, **kw)
            torch.cuda.synchronize()
            when = timed(kernel, lambda: real[0](*args, **kw))
            # without alphas the second output is an unwritten placeholder
            equal = all(torch.equal(a, b) for i, (a, b) in enumerate(zip(got, again))
                        if i != 1 or key[1])
            B = args[2].shape[2]
            _, err = _check_fwd(f"{label}: {kernel.name} on the path's call (form {form}, it_mode "
                                f"{key[0]}, alphas {key[1]}; {args[0].shape[0]} grids x {B} "
                                f"chains x K={args[0].shape[2]}, {when}; "
                                f"{int((args[3][:, 2] == 0).sum())} live read slots, at most "
                                f"{int(args[7].max())} a grid{'' if reads else ': the read-free re-run'}"
                                f"; a second launch equal bit for bit: {equal})", got, ref,
                                list(args), key[1])
            if not equal:
                _fail(f"{label}: two launches of gibbs_fwd differ on the path's call")
            res["gibbs_fwd"].append(err)
            res["forms"].append(("gibbs_fwd", form, key))
        return got

    def bank(lemg, beta, trans, ht, u, is_end, perm_mask, K_real, **kw):
        got = real[3](lemg, beta, trans, ht, u, is_end, perm_mask, K_real, **kw)
        if len(res["nipt_bank"]) < n_bank:
            args = (lemg, beta, trans, ht, u, is_end, perm_mask, K_real)
            form = nb.bank_form(lemg.shape[2], lemg.shape[0])
            ref_c, ref_p = nb.bank_scan_plain(*args)
            kernel = {gs.GLOBAL: nb.BANK_GLOBAL_KERNEL,
                      gs.CLUSTER: nb.BANK_CLUSTER_KERNEL}.get(form, nb.BANK_KERNEL)
            again = real[3](*args, **kw)
            torch.cuda.synchronize()
            when = timed(kernel, lambda: real[3](*args, **kw))
            same = (got[0] == ref_c).all(dim=0)
            err = (got[1] - ref_p)[:, same].abs().max().item() if same.any() else float("inf")
            equal = torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
            B = same.shape[0]
            print(f"{label}: {kernel.name} on the path's call (form {form}; {lemg.shape[0]} grids "
                  f"x {B} chains x K={lemg.shape[2]}, {int(is_end.sum())} block ends; {when}): "
                  f"{int(same.sum())}/{B} chains draw the same relabellings, max |probability "
                  f"err| {err:.3e} (tolerance atol 1e-4), a second launch equal bit for bit: "
                  f"{equal}", flush=True)
            if 1.0 - int(same.sum()) / B > PARTED_CHAINS_BOUND or not err <= 1e-4 or not equal:
                _fail(f"{label}: nipt_bank disagrees with its plain version on the path's call")
            res["nipt_bank"].append(err)
            res["forms"].append(("nipt_bank", form, None))
        return got

    def bwd(lemg, trans, **kw):
        got = real[1](lemg, trans, **kw)
        if len(res["gibbs_bwd"]) < n_bwd:
            ref = gs.bwd_sweep_plain(lemg, trans, kw["K_real"])
            err = (got - ref).abs().max().item()
            form = gs.bwd_form(lemg.shape[2])
            kernel = {gs.GLOBAL: gs.BWD_GLOBAL_KERNEL,
                      gs.CLUSTER: gs.BWD_CLUSTER_KERNEL}.get(form, gs.BWD_KERNELS[kw["nl"]])
            equal = torch.equal(got, real[1](lemg, trans, **kw))
            when = timed(kernel, lambda: real[1](lemg, trans, **kw))
            print(f"{label}: {kernel.name} on the path's call (form {form}; {lemg.shape[0]} "
                  f"grids x {lemg.shape[1]} state rows x K={lemg.shape[2]}, {when}): max "
                  f"|beta err| {err:.3e} (tolerance rtol 1e-5, atol 1e-6), a second launch "
                  f"equal bit for bit: {equal}", flush=True)
            if not torch.allclose(got, ref, rtol=1e-5, atol=1e-6) or not equal:
                _fail(f"{label}: gibbs_bwd disagrees with its plain version on the path's call")
            res["gibbs_bwd"].append(err)
            res["forms"].append(("gibbs_bwd", form, lemg.shape[1]))
        return got

    def core(gl, words, trans2, thin, K, K_top, ref_error, CG=None, cap=None):
        got = real[2](gl, words, trans2, thin, K, K_top, ref_error, CG=CG, cap=cap)
        if not res["fb_fwd"]:
            dl, csum = fbk._gl_log_ratios(gl, float(ref_error))
            ck, lg = fbk.fb_forward_plain(dl, words, trans2, K, CG)
            d, tv, ti = fbk.fb_backward_plain(dl, words, ck, trans2, thin, K, K_top,
                                              float(ref_error), CG)[:3]
            err_lg = (got[1] - (lg + csum)).abs().max().item()
            err_d = (got[0] - d).abs().max().item()
            err_tv, idx_ok, n_firm = _topk_agree(got[2], got[3], tv, ti, thin)
            v = tv[thin >= 0]
            n_tied = int((v[:, :, :-1] == v[:, :, 1:]).sum())
            print(f"{label}: the fused FB on the path's first row batch ({gl.shape[0]} rows; "
                  f"{n_tied} exact ties between neighbouring plain top-K values): "
                  f"max |loglik err| {err_lg:.3e} (|loglik| up to "
                  f"{(lg + csum).abs().max().item():.1f}), max |dosage err| {err_d:.3e}, max "
                  f"|top-K value err| {err_tv:.3e}, indices equal where the values settle them: {idx_ok} "
                  f"({n_firm} places) (tolerance loglik rtol 1e-5 + atol 1e-2, dosage / top-K "
                  f"atol 1e-4)", flush=True)
            if (not torch.allclose(got[1], lg + csum, rtol=1e-5, atol=1e-2) or err_d > 1e-4
                    or err_tv > 1e-4 or not idx_ok):
                _fail(f"{label}: the fused FB disagrees with its plain version on the path's "
                      f"call; first top-K difference: {_topk_mismatch(got[2], got[3], tv, ti, thin)}")
            res["fb_fwd"].append(err_lg)
            res["fb_bwd"].append(err_d)
        return got

    gibbs.fwd_sweep, gibbs.bwd_sweep, fbk.fb_core, gibbs.bank_scan = fwd, bwd, core, bank
    try:
        yield res
    finally:
        gibbs.fwd_sweep, gibbs.bwd_sweep, fbk.fb_core, gibbs.bank_scan = real


def _note_path_ms(path_ms, path, res):
    """Keeps, for each kernel that _path_probe timed on `path`'s calls, the
    median of its times there (path_ms[kernel][path], ms a launch)."""
    import statistics

    for name, ms in res["ms"].items():
        path_ms.setdefault(name, {})[path] = statistics.median(ms)


def _probe_report(label, res, needed):
    """Fails if a kernel of `needed` (row names) went unchecked by
    _path_probe; returns {row name: largest error}. The FB rows give the
    dosage error of fb_bwd; fb_fwd's log-likelihood error (of sums up to
    ~1e4) is not an error of the row's checkpoints, so it is left out."""
    missed = [n for n in needed if not res.get(n)]
    if missed:
        _fail(f"{label}: {missed} ran unchecked against their plain versions")
    return {n: max(res[n]) for n in needed if n != "fb_fwd"}


def check_fb_plan_at(fb, dl, rows, label, family=None, splits=None):
    """The FB kernels that fb_plan takes for `rows` rows on fb's panel (of
    `family` and `splits` when given), held against their plain versions on dl at the
    main checks' tolerances, the forms they take printed; for the K-split
    family also fb_max_tiled's and fb_fwd_tiled's two launches equal bit
    for bit (the backward's: in _check_tiled). Returns {row name: max error}."""
    import torch
    from quilt_tpu_torch.kernels import fb as fbk

    dev = fb.device_tensors("cuda")
    words, trans2, thin = dev["words"], dev["trans2"], dev["thin_flag"]
    family, per_call, splits = fbk.fb_plan(rows, fb, family, splits)
    where = (f" at {dl.shape[0]} rows x K={fb.K} x {fb.nGrids} grids ({label}: fb_plan at {rows} "
             f"rows -> {family}, {per_call} rows per call, {splits} blocks per row)")
    if family == "fused":
        cg = fbk.fused_cg(fb.K_pad, fb.nGrids)
        smem, cpt = fbk._bwd_storage(cg, fb.K_pad, 8)
        print(f"fused FB{where}: checkpoint interval {cg}, the chunk's alphas in "
              f"{'shared' if smem else 'global'} memory, {fbk._cpt(fb.K_pad)} / {cpt} haplotypes "
              f"a thread in registers forward / backward (0: the general form)", flush=True)
        r = _check_fused(dl, words, trans2, thin, fb.K, 8, 0.001, where)
        return {"fb_fwd": r[5], "fb_bwd": r[6]}
    kt = fb.K_pad // splits
    print(f"K-split FB{where}: {tiled_forms(fb.K_pad, splits, fb.nGrids)}", flush=True)
    r = _check_tiled(dl, words, trans2, thin, fb.K, kt, 8, 0.001, where,
                     timer=lambda fn: (fn(), None))
    same = (torch.equal(fbk.fb_max_tiled(dl, words, fb.K, kt), r["mx"])
            and all(torch.equal(a, b) for a, b in zip(
                fbk.fb_forward_tiled(dl, words, trans2, r["mx"], fb.K, kt), r["fwd"])))
    print(f"fb_max_tiled and fb_fwd_tiled{where}: two launches equal bit for bit: {same}",
          flush=True)
    if not same:
        _fail(f"a K-split kernel{where} gave other bits on a second launch")
    return {"fb_max_tiled": r["err_max"], "fb_fwd_tiled": r["err_ck"], "fb_bwd_tiled": r["err_d"]}


def _fb_kernels_of(family, fused, tiled):
    return fused if family == "fused" else tiled


def run_bench(counted, gibbs_k, fused, tiled, gdos):
    """Phase bench: the worlds that only the benchmark programs run, built
    and driven by quilt_tpu_torch/bench's functions. The FB family fb_plan
    takes at bench.fb's 2,048 grids x 28 rows, and the fused one, against
    their plain versions, then bench.fb once (its JSON line); QUILT1 on
    ONT reads (8 samples, ~6 kb reads at phred 10) in the benchmark's own
    world (bench.full.end_to_end_ont on a fast_packed_panel; r2 min / mean
    >= ONT_BENCH_R2_MIN / _MEAN) and on the e2e world's panel and shape (r2
    >= 0.8), the sweeps and the fused FB of both held against their plain
    versions on the calls the path makes (_path_probe); the K-split FB at K = 98,304 x 512 grids (the
    16-row bench input): the kernels fb_plan takes at 16 rows and at the
    K100k batch's 112 held against their plain versions on 4 rows, and both
    families timed at 16 and 112 rows; QUILT1 and QUILT2 against the
    98,304-haplotype panel (8 samples; r2 >= 0.9 / 0.85; the plan and the
    peak memory printed); QUILT1 against a 194,512-haplotype panel (k200k,
    K200K_SAMPLES samples; r2 >= 0.9), then fb_plan's choices timed on its
    FB inputs at 16 and 112 rows; and chains 0-6 of a 256-chain Gibbs call
    equal to a 7-chain call on the same inputs, bit for bit. Returns
    (launches by path, {row name: largest error of its kernel here})."""
    import numpy as np
    import torch
    from quilt_tpu_torch.bench import fb as bfb
    from quilt_tpu_torch.bench import full as bfull
    from quilt_tpu_torch.bench import gibbs as bgibbs
    from quilt_tpu_torch.engine import driver
    from quilt_tpu_torch.kernels import fb as fbk
    from quilt_tpu_torch.panel.mspbwt import build_mspbwt_indices

    rng = np.random.default_rng(SEED + 14)
    launches, errs = {}, {}

    def note(found):
        for name, e in found.items():
            errs[name] = max(errs.get(name, 0.0), e)

    t = time.time()
    fw = bfb.fb_world(rng)
    gl = torch.as_tensor(fw["gl"], device="cuda")
    dl = fbk._gl_log_ratios(gl, 0.001)[0]
    note(check_fb_plan_at(fw["fb"], dl, fw["rows"], "bench.fb"))
    if bfb.plan_of(fw, fw["rows"])["family"] != "fused":
        note(check_fb_plan_at(fw["fb"], dl, fw["rows"], "bench.fb, the fused family", "fused"))
    del gl, dl
    for k in counted:
        k.launches = 0
    line = bfb.fb_report(fw, "cuda")
    launches["bench_fb"] = {k.name: k.launches for k in counted}
    print(f"bench.fb (7 FB calls: a warm-up and {bfb.REPS} timed), launches "
          f"{launches['bench_fb']}:", flush=True)
    print(json.dumps(line), flush=True)
    check_launched("bench_fb", launches["bench_fb"],
                   _fb_kernels_of(bfb.plan_of(fw, fw["rows"])["family"], fused, tiled))
    del fw
    t = _bench_section("fb", t)

    # the benchmark's own ONT world (bench.full.e2e_world: 8 samples against
    # a fast_packed_panel of the e2e shape): the probe holds the kernels on a
    # call of the section's config of its own, then bench.full.end_to_end_ont
    # runs counted
    ontb = bfull.e2e_world(rng, 8, read_length_bp=bfull.ONT_READ_BP, phred=bfull.ONT_PHRED)
    probe = {}
    with _path_probe("ont_bench", probe):
        bfull.run_impute(ontb, bfull.e2e_config(len(ontb["samples"])), "cuda")
    for k in counted:
        k.launches = 0
    sec = bfull.end_to_end_ont(ontb, "cuda")
    launches["ont_bench"] = {k.name: k.launches for k in counted}
    print(f"ont_bench (bench.full.end_to_end_ont, a warm-up and a timed call; launches "
          f"{launches['ont_bench']}):", flush=True)
    print(json.dumps(sec), flush=True)
    if sec["r2_min"] < ONT_BENCH_R2_MIN or sec["r2_mean"] < ONT_BENCH_R2_MEAN:
        _fail(f"ont_bench r2 against truth under min {ONT_BENCH_R2_MIN} / mean "
              f"{ONT_BENCH_R2_MEAN}: {sec['r2_min']:.4f} / {sec['r2_mean']:.4f}")
    check_launched("ont_bench", launches["ont_bench"], gibbs_k + fused)
    note(_probe_report("ont_bench", probe, ("gibbs_fwd", "gibbs_bwd", "fb_fwd", "fb_bwd")))
    del ontb

    # the e2e world's panel and shape (simulate.make_world), its reads ONT's
    ont = make_world(read_length_bp=bfull.ONT_READ_BP, phred=bfull.ONT_PHRED)
    print(f"ont world: reads of ~{bfull.ONT_READ_BP} bp at phred {bfull.ONT_PHRED}, "
          f"{np.mean([np.diff(r.offsets).mean() for r in ont['samples']]):.1f} SNPs a read",
          flush=True)
    probe = {}
    out, _, launches["ont"] = run_e2e(ont, counted, _bench_config(8), "ont",
                                      probe=lambda: _path_probe("ont", probe))
    if min(out.r2_per_sample) < 0.8:
        _fail(f"ont r2 against truth below 0.8: {out.r2_per_sample}")
    check_launched("ont", launches["ont"], gibbs_k + fused)
    note(_probe_report("ont", probe, ("gibbs_fwd", "gibbs_bwd", "fb_fwd", "fb_bwd")))
    del ont, out
    t = _bench_section("ont", t)

    tw = bfull.tiled_world(rng, bfull.K_BIG)
    dl = fbk._gl_log_ratios(torch.as_tensor(tw["gl"], device="cuda"), 0.001)[0]
    # the splits fb_plan takes at the bench input's 16 rows and the K100k
    # batch's 112, and 2 blocks a row (49,152 haplotypes a block: the chunk
    # alphas in global planes)
    splits = {fbk.fb_plan(rows, tw["fb"])[2]: rows for rows in (112, tw["rows"])}
    for s in sorted(set(splits) | {2}, reverse=True):
        label = f"fb_plan's split at {splits[s]} rows" if s in splits else "forced"
        note(check_fb_plan_at(tw["fb"], dl[:4].contiguous(), splits.get(s, 112), label,
                              None if s in splits else "tiled", s))
    del dl
    time_fb_plan(tw["fb"], (tw["rows"], 112))
    r = bfb.time_fb(tw, "cuda", reps=3)
    print(f"fb_kernel_tiled K{bfull.K_BIG} ({tw['rows']} rows x {tw['nGrids']} grids, plan "
          f"{r['plan']}): {r['seconds'] * 1e3:.2f} ms a call, {r['cells_per_s']:.4g} cells/s",
          flush=True)
    del tw
    torch.cuda.empty_cache()

    t0 = time.time()
    big = bfull.e2e_world(rng, 8, K=bfull.K_BIG)
    print(f"k100k world: K={big['prep'].K}, nSNPs={big['prep'].nSNPs}, 8 samples, "
          f"{sum(r.nReads for r in big['samples'])} reads ({time.time() - t0:.1f} s to simulate "
          f"and prepare)", flush=True)
    cfg = _bench_config(8)
    plan = bfull.fb_plan_of(big["prep"], cfg, "cuda", 8 * 7 * 2)
    print(f"k100k: fb_plan at 112 rows -> {plan}"
          + (f"; {tiled_forms(big['prep'].K, plan['splits'], big['prep'].nGrids)}"
             if plan["family"] == "tiled" else ""), flush=True)
    if plan["family"] == "tiled" and not _non_general(big["prep"].K, plan["splits"],
                                                      big["prep"].nGrids):
        _fail("k100k: the K-split FB took a general form within the new forms' reach")
    out, _, launches["k100k"] = run_e2e(big, counted, cfg, "k100k")
    if min(out.r2_per_sample) < 0.9:
        _fail(f"k100k r2 against truth below 0.9: {out.r2_per_sample}")
    check_launched("k100k", launches["k100k"],
                   gibbs_k + _fb_kernels_of(plan["family"], fused, tiled))
    t0 = time.time()
    big["prep"].ms_indices = build_mspbwt_indices(big["prep"].panel.hapMatcher)
    print(f"k100k_quilt2: msPBWT indices built in {time.time() - t0:.1f} s (host), rank by "
          f"{'bit planes' if big['prep'].ms_indices[0].planes is not None else 'occurrence lists'}",
          flush=True)
    out, _, launches["k100k_quilt2"] = run_e2e(big, counted, _bench_config(8, use_mspbwt=True),
                                               "k100k_quilt2")
    if min(out.r2_per_sample) < 0.85:
        _fail(f"k100k_quilt2 r2 against truth below 0.85: {out.r2_per_sample}")
    check_launched("k100k_quilt2", launches["k100k_quilt2"], gibbs_k + [gdos])
    del big, out
    torch.cuda.empty_cache()
    t = _bench_section("k100k", t)

    # a panel of TOPMed r2's size (97,256 samples = 194,512 haplotypes),
    # QUILT1 on 8 samples as k100k
    t0 = time.time()
    huge = bfull.e2e_world(rng, K200K_SAMPLES, K=bfull.K_HUGE)
    print(f"k200k world: K={huge['prep'].K}, nSNPs={huge['prep'].nSNPs}, {K200K_SAMPLES} samples, "
          f"{sum(r.nReads for r in huge['samples'])} reads ({time.time() - t0:.1f} s to simulate "
          f"and prepare)", flush=True)
    cfg = _bench_config(K200K_SAMPLES)
    plan = bfull.fb_plan_of(huge["prep"], cfg, "cuda", K200K_SAMPLES * 7 * 2)
    K_pad = -(-bfull.K_HUGE // 128) * 128
    print(f"k200k: fb_plan at {K200K_SAMPLES * 14} rows -> {plan}"
          + (f"; {tiled_forms(K_pad, plan['splits'], huge['prep'].nGrids)}"
             if plan["family"] == "tiled" else ""), flush=True)
    if plan["family"] == "tiled" and not _non_general(K_pad, plan["splits"], huge["prep"].nGrids):
        _fail("k200k: the K-split FB took a general form within the new forms' reach")
    out, _, launches["k200k"] = run_e2e(huge, counted, cfg, "k200k")
    if min(out.r2_per_sample) < 0.9:
        _fail(f"k200k r2 against truth below 0.9: {out.r2_per_sample}")
    check_launched("k200k", launches["k200k"],
                   gibbs_k + _fb_kernels_of(plan["family"], fused, tiled))
    # fb_plan's choices timed on the world's own FB inputs at 16 and 112 rows
    fbi = driver._region_context(huge["prep"], cfg, "cuda").fb_state()[0]
    for rows in (16, 112):
        fam, per_call, s = fbk.fb_plan(rows, fbi)
        print(f"K-split FB at K={fbi.K}: fb_plan at {rows} rows -> {fam}, {per_call} rows per "
              f"call, {s} blocks per row: {tiled_forms(fbi.K_pad, s, fbi.nGrids)}", flush=True)
    time_fb_plan(fbi, (16, 112))
    del huge, out, fbi
    torch.cuda.empty_cache()
    t = _bench_section("k200k", t)

    gw = bgibbs.gibbs_world(rng, "cuda")
    st = bgibbs.gibbs_state(gw, 256, bgibbs.N_ITS, rng)
    st7 = bgibbs.first_chains(gw, st, 7)
    wide, narrow = bgibbs.run_gibbs(gw, st), bgibbs.run_gibbs(gw, st7)
    same = torch.equal(wide.H[:7], narrow.H) and torch.equal(wide.per_it[:, :7], narrow.per_it)
    t256 = _median_ms(lambda: bgibbs.run_gibbs(gw, st), 3)
    t7 = _median_ms(lambda: bgibbs.run_gibbs(gw, st7), 3)
    print(f"gibbs at 256 chains ({gw['reads'].nReads} reads, K={gw['Kp']}, form "
          f"{bgibbs.form_name(gw['Kp'])}): chains 0-6 equal to a 7-chain call on the same inputs "
          f"bit for bit (labels, logc and every per-iteration term): {same}; a 21-sweep call "
          f"{t256:.1f} ms at 256 chains, {t7:.1f} ms at 7", flush=True)
    if not same:
        _fail("chains 0-6 of the 256-chain Gibbs call differ from the 7-chain call")
    _bench_section("gibbs256", t)
    return launches, errs


PHASES = ("kernels", "e2e", "dist", "quilt2", "largek", "bench", "nipt", "wide", "hla", "map", "diag",
          "cli")


def _took(name, t):
    print(f"phase {name}: {time.time() - t:.1f} s", flush=True)
    return time.time()


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of the phases to run while developing "
                         "(the build always runs); only a full run prints the result lines")
    phases = set(ap.parse_args().phases.split(","))
    if not phases <= set(PHASES):
        _fail(f"unknown phase in {sorted(phases)}; the phases are {PHASES}")
    try:
        import torch
    except ImportError:
        _fail("torch is not installed")
    if not torch.cuda.is_available():
        _fail("no CUDA device (torch.cuda.is_available() is false)")
    if not os.path.isdir(os.path.join(HERE, "quilt_tpu_torch")):
        _fail("run from a checkout of the repository (quilt_tpu_torch/ is missing)")
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}", flush=True)

    from quilt_tpu_torch import _build

    t = time.time()
    reports = _build.build_all()
    print(f"build: {sorted(reports)} in {time.time() - t:.1f} s", flush=True)
    for name, log in reports.items():
        entry = None
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
                _note_ptxas(name, entry, line)
            elif "Compiling entry function" in line:
                # the mangled name carries the template arguments (threads,
                # columns a thread, ..., NL) of the instantiation
                entry = line.split(chr(39))[1]
                print(f"  {name}: {entry[:110]}")

    from quilt_tpu_torch.kernels import fb, fb_sharded, gibbs_dosage, gibbs_sweep, nipt_bank

    gfwd, gbwd, gdos = gibbs_sweep.FWD_KERNEL, gibbs_sweep.BWD_KERNEL, gibbs_dosage.DOS_KERNEL
    nl3 = [gibbs_sweep.FWD_KERNELS[3], gibbs_sweep.BWD_KERNELS[3], gibbs_dosage.DOS_KERNELS[3]]
    bank = nipt_bank.BANK_KERNEL
    fused = [fb.FWD_KERNEL, fb.BWD_KERNEL]
    capture = fb.BWD_CAPTURE_KERNEL
    # the forms that take any K, and the cluster forms that took their place
    # up to K = 16,384 (12,288 forward at NL = 3)
    wide = [gibbs_sweep.FWD_GLOBAL_KERNELS[2], gibbs_sweep.FWD_GLOBAL_KERNELS[3],
            gibbs_sweep.BWD_GLOBAL_KERNEL, nipt_bank.BANK_GLOBAL_KERNEL]
    clusters = [gibbs_sweep.FWD_CLUSTER_KERNELS[2], gibbs_sweep.FWD_CLUSTER_KERNELS[3],
                nipt_bank.BANK_CLUSTER_KERNEL, gibbs_sweep.BWD_CLUSTER_KERNEL]
    tiled = [fb.MAX_TILED_KERNEL, fb.FWD_TILED_KERNEL, fb.BWD_TILED_KERNEL]
    # the panel-sharded FB's segment kernels (no Pallas counterpart): the
    # local passes and the fused steps
    seg = list(fb_sharded.KERNELS)
    kernels = ([gfwd, gbwd, gdos] + nl3 + [bank] + fused + [capture] + wide + clusters + seg
               + tiled)   # the order of rows
    # the previous forms of the redesigned kernels (timings only), and the
    # backward cluster form's clock-counting instantiation, must launch on
    # no path
    prev_tiled = [fb._PREV_REMAT_TILED, fb._PREV_BWD_TILED, fb._PREV_FWD_TILED,
                  fb._PREV_MAX_TILED, nipt_bank._PREV_BANK_KERNEL,
                  gibbs_sweep.BWD_CLUSTER_SPLIT_KERNEL,
                  *gibbs_dosage._PREV_DOS_KERNELS.values(), *fb_sharded._PREV_KERNELS]
    counted = kernels + prev_tiled
    rows, launches, mx_err, wide_forms = [], {}, 0.0, {}
    t = time.time()

    if phases & {"kernels", "e2e", "dist"}:
        world = make_world()
        gone = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "quilt_tpu"))
        if gone:
            _fail(f"the port pulled in the JAX package or jax: {gone[:5]}")
        if "kernels" in phases:
            rows += check_kernels(world)
            rows += check_global_forms()
            wide_forms = check_wide_tiled()
            # fb_plan's decision points: the QUILT1 batch (112 rows), the
            # NIPT one (84), lone samples (14) and 2-4 samples; 200 rows
            # beyond one wave of fused rows; a ragged K_pad (8,320)
            time_fb_plan(world["fb"], (14, 28, 56, 84, 112))
            for K, n in ((8192, (14, 28, 56, 112, 200)), (8320, (28,)), (10240, (28, 56, 112)),
                         (20480, (14, 28, 56, 112, 200))):
                time_fb_plan(synthetic_fb(K), n)
            t = _took("kernels", t)
        single = None
        if "e2e" in phases:
            out, _, launches["quilt1"] = run_e2e(world, counted, e2e_config(8), "e2e")
            if min(out.r2_per_sample) < 0.9:
                _fail(f"e2e r2 against truth below 0.9: {out.r2_per_sample}")
            check_launched("e2e", launches["quilt1"], [gfwd, gbwd] + fused)
            if any(launches["quilt1"][k.name] for k in seg):
                _fail(f"e2e launched a segment kernel of the sharded FB: {launches['quilt1']}")
            single = out
            t = _took("e2e", t)
        if "dist" in phases:
            dist_rows, launches["dist"], mx_err = run_dist(world, counted, single, seg, fused)
            rows += dist_rows
            t = _took("dist", t)
        del world

    if "quilt2" in phases:
        world2 = make_world(quilt2=True)
        out, truth_gen, launches["quilt2"] = run_e2e(world2, counted, e2e_config(8, quilt2=True),
                                                     "quilt2")
        quilt2_report(world2, out, truth_gen)
        if min(out.r2_per_sample) < 0.85:
            _fail(f"quilt2 r2 over all sites below 0.85: {out.r2_per_sample}")
        check_launched("quilt2", launches["quilt2"], [gfwd, gbwd, gdos])
        del world2
        t = _took("quilt2", t)

    if "largek" in phases:
        # large panel: K = 40,960; 2 samples x 7 chains x 2 haplotypes = 28 FB rows
        world3 = make_world(n_samples=2, K=40960)
        rows += check_tiled_kernels(world3["fb"])
        time_fb_plan(world3["fb"], (28, 56, 112, 200))
        out, _, l3 = run_e2e(world3, counted, e2e_config(2), "largek")
        launches["largek"] = l3
        if min(out.r2_per_sample) < 0.9:
            _fail(f"largek r2 against truth below 0.9: {out.r2_per_sample}")
        check_launched("largek", l3, [gfwd, gbwd] + tiled)
        if any(l3[k.name] for k in fused):
            _fail(f"largek launched a fused FB kernel: {l3}")
        # one launch of each tiled kernel an FB call, 6 FB calls a largek call
        if [l3[k.name] for k in tiled] != [6, 6, 6]:
            _fail(f"largek: the tiled kernels did not launch once an FB call each: {l3}")
        del world3
        t = _took("largek", t)

    path_errs = {}   # {row name: error} of the checks on the paths' own calls
    path_ms = {}     # {row name: {path: ms a launch on the path's own calls}}
    if "bench" in phases:
        l_bench, path_errs = run_bench(counted, [gfwd, gbwd], fused, tiled, gdos)
        launches.update(l_bench)
        t = _took("bench", t)

    if "nipt" in phases:
        # QUILT1-NIPT: 8 samples at 2x, two fetal fractions -> two batches of
        # 4 samples x 7 chains = 28 chains = 84 state rows and 84 FB rows
        ffs = [0.1] * 4 + [0.2] * 4
        world4 = make_world(ffs=ffs, coverage=2.0)
        out, _, l4 = run_e2e(world4, counted, e2e_config(8, nipt=True), "nipt")
        launches["nipt"] = l4
        nipt_report("nipt", world4, out)
        check_launched("nipt", l4, nl3[:2] + [bank] + fused)
        if l4[gfwd.name] or l4[gbwd.name]:
            _fail(f"nipt launched an NL = 2 sweep: {l4}")
        del world4
        # QUILT2-NIPT on the QUILT2 world's panel: the dosages come from the
        # Gibbs dosage kernel at NL = 3
        world5 = make_world(n_samples=4, quilt2=True, ffs=[0.2] * 4, coverage=2.0)
        out, _, l5 = run_e2e(world5, counted, e2e_config(4, quilt2=True, nipt=True), "nipt2")
        launches["nipt2"] = l5
        nipt_report("nipt2", world5, out)
        check_launched("nipt2", l5, nl3 + [bank])
        del world5
        t = _took("nipt", t)

    if "wide" in phases:
        # Gibbs at a Ksubset past the forms held in shared memory: a
        # panel of 10,496 haplotypes over 1,024 SNPs, 2 samples. Diploid at
        # Ksubset 10,368 takes the forward's and the backward's cluster
        # forms; NIPT at 8,192 the forward's cluster form at NL = 3 and the
        # bank's. Then the forms' capacity at a full batch of state rows, on
        # a panel of 16,512: wide16k (diploid, Ksubset 16,384, 8 samples =
        # 56 chains, 112 backward rows) and wide_nipt12k (NIPT, 12,288, 4
        # samples = 28 chains, 84 rows). The forward's and the bank's global
        # forms must not launch, nor the backward's where bwd_form takes its
        # cluster form; the path's own calls are held against the plain
        # versions (_path_probe, the warm-up call). wide must launch the
        # backward's cluster form.
        bwd_kernel = lambda K, nl: {gibbs_sweep.CLUSTER: clusters[3],
                                          gibbs_sweep.GLOBAL: wide[2]}.get(
            gibbs_sweep.bwd_form(K), gibbs_sweep.BWD_KERNELS[nl])
        wide_paths = []

        def wide_path(path, world, cfg, K, rows, needed, nipt):
            """One wide path; `rows` the backward's state rows it must meet."""
            probe = {}
            out, _, l = run_e2e(world, counted, cfg, path, probe=lambda: _path_probe(path, probe))
            launches[path] = l
            if nipt:
                nipt_report(path, world, out)
            elif min(out.r2_per_sample) < 0.9:
                _fail(f"{path} r2 against truth below 0.9: {out.r2_per_sample}")
            bk = bwd_kernel(K, 3 if nipt else 2)
            check_launched(path, l, needed + [bk])
            errs = _probe_report(path, probe, ("gibbs_fwd", "gibbs_bwd") + (
                ("nipt_bank",) if nipt else ()))
            met = {f[2] for f in probe["forms"] if f[0] == "gibbs_bwd"}
            if met != {rows}:
                _fail(f"{path}: the backward ran at {met} state rows, not {rows}")
            for k, name in ((needed[0], "gibbs_fwd"), (bk, "gibbs_bwd")) + (
                    ((clusters[2], "nipt_bank"),) if nipt else ()):
                path_errs[k.name] = max(path_errs.get(k.name, 0.0), errs[name])
            _note_path_ms(path_ms, path, probe)
            wide_paths.append((path, l, bk))
            return probe

        world6 = make_world(n_samples=2, K=10496, nSNPs=1024)
        wide_path("wide", world6, e2e_config(2, ksubset=10368), 10368, 28,
                  [clusters[0], clusters[3]], False)
        del world6
        world7 = make_world(n_samples=2, K=10496, nSNPs=1024, ffs=[0.2] * 2, coverage=2.0)
        probe = wide_path("wide_nipt", world7, e2e_config(2, nipt=True, ksubset=8192), 8192, 42,
                          [clusters[1], clusters[2]], True)
        if not any(f[0] == "gibbs_fwd" and not f[2][2] for f in probe["forms"]):
            _fail("wide_nipt: the block move's read-free forward re-run went unchecked")
        del world7
        # the forms' capacity: the forward's (16,384; NL = 3 12,288) at a full batch
        if (gibbs_sweep.fwd_form(16384, 2), gibbs_sweep.fwd_form(12288, 3)) != (gibbs_sweep.CLUSTER,) * 2:
            _fail("the forward's cluster forms do not hold their capacity")
        world9 = make_world(n_samples=8, K=16512, nSNPs=1024, coverage=2.0)
        wide_path("wide16k", world9, e2e_config(8, ksubset=16384), 16384, 112, [clusters[0]], False)
        del world9
        world10 = make_world(n_samples=4, K=16512, nSNPs=1024, ffs=[0.2] * 4, coverage=2.0)
        wide_path("wide_nipt12k", world10, e2e_config(4, nipt=True, ksubset=12288), 12288, 84,
                  [clusters[1], clusters[2]], True)
        del world10
        for path, l, bk in wide_paths:
            stray = {k.name: l[k.name] for k in wide if l[k.name] and k is not bk}
            if stray:
                _fail(f"{path} launched a global form the cluster forms took over: {stray}")
        t = _took("wide", t)
    if "hla" in phases:
        launches["hla"] = run_hla(counted, [gfwd, gbwd, fb.FWD_KERNEL, capture])
        if launches["hla"][fb.BWD_KERNEL.name]:
            _fail(f"hla launched the FB backward without capture: {launches['hla']}")
        t = _took("hla", t)
    if phases & {"map", "diag"}:
        world8 = make_world(hot_map=True)
        if "map" in phases:
            launches.update(run_map(world8, counted, [gfwd, gbwd] + fused,
                                    nl3[:2] + [bank] + fused))
            t = _took("map", t)
        if "diag" in phases:
            # the per-sample engine's FB runs a sample's 7 chains x 2 rows, OHD's
            # 2 rows: the kernels fb_plan takes there, against their plain versions
            check_fb_at_rows(world8["fb"], (14, 2))
            launches["diag"] = run_diag(world8, counted, [gfwd, gbwd, gdos], [fused, tiled])
            t = _took("diag", t)
        del world8
    if "cli" in phases:
        run_cli()
        t = _took("cli", t)

    stale = {path: {k.name: l[k.name] for k in prev_tiled if l[k.name]}
             for path, l in launches.items()}
    if any(stale.values()):
        _fail(f"a path launched a previous form of a redesigned kernel: {stale}")
    print(smi)
    if phases != set(PHASES):
        print(f"partial run (phases {sorted(phases)}): no result line")
        return 0
    if len(rows) != len(kernels):
        _fail(f"{len(rows)} kernel rows for {len(kernels)} kernels")
    for row, k in zip(rows, kernels):
        if k is fb.MAX_TILED_KERNEL:
            # also held on the sharded FB's shards in phase dist
            row["max_abs_err"] = max(row["max_abs_err"], mx_err)
        # and the kernels on the bench and wide phases' own calls
        row["max_abs_err"] = max(row["max_abs_err"], path_errs.get(row["name"], 0.0))
        if row["name"] in path_ms:
            row["ms_on_path"] = path_ms[row["name"]]
        if row["name"] in wide_forms:
            # the K-split forms at the widest blocks (check_wide_tiled)
            row["forms"] = wide_forms[row["name"]]
        row["launches_by_path"] = {path: l[k.name] for path, l in launches.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
