#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (quilt_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   - compile every CUDA source of the port with nvcc (sm_90a),
               one process per source, and print the build time;
  2. kernels - run each ported kernel at the full-width shapes of the main
               paths against its plain PyTorch version, print the error and
               the median times of both (CUDA events);
  3. e2e     - QUILT1 diploid imputation through the batched engine at
               full width (K=5,120 panel haplotypes, 16,384 SNPs, Ksubset
               600, 7 chains x 3 seek iterations x 21 sweeps, 8 samples at
               ~1x coverage, simulated from a seed); prints seconds,
               samples/s, r2 against truth, the per-stage timers and each
               kernel's launch count; the four kernels of the path must
               launch;
  4. quilt2  - QUILT2 diploid imputation (msPBWT selection + rare/common
               all-SNP Gibbs) of the same shape, with 10% of the sites
               rewritten to 1-4 carriers (rare); prints samples/s, r2 over
               all / common / rare sites and the per-stage timers; the Gibbs
               forward, backward and dosage kernels must launch;
  5. cli     - small file-based `prepare` + `impute` and `prepare2` +
               `impute2` runs through the port's CLI; checks the VCFs.
The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20240611


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


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions at full-width shapes
# ---------------------------------------------------------------------------

def check_kernels(world):
    """Each ported kernel vs its plain version on the card; returns the
    rows of the kernels line (launch counts filled in after the e2e)."""
    import numpy as np
    import torch
    from quilt_tpu_torch.kernels import fb as fbk
    from quilt_tpu_torch.kernels import gibbs_dosage as gd
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
    got = gs.fwd_sweep(*args, **kw)
    ref = gs.fwd_sweep_plain(*args, K_real=K_real, it_mode=2)
    torch.cuda.synchronize()
    live = args[3][:, 2] == 0
    agree = (got[2][live] == ref[2][live]).float().mean().item()
    # a uniform within rounding of a candidate boundary may draw the other
    # label and fork that chain; compare state only on rows that agree
    same = ((got[2] == ref[2]) | ~live).all(dim=0).all(dim=0)          # [B]
    rows2 = torch.cat([same, same])
    err_lemg = (got[0] - ref[0]).abs()[:, rows2].max().item()
    err_logc = (got[3] - ref[3]).abs()[rows2].max().item()
    ok = (agree > 0.995 and torch.allclose(got[0][:, rows2], ref[0][:, rows2], rtol=1e-4, atol=1e-3)
          and torch.allclose(got[3][rows2], ref[3][rows2], rtol=1e-4, atol=1e-3))
    print(f"gibbs_fwd: labels agree {agree:.6f}, {int(same.sum())}/{B} rows identical, "
          f"max |lemg err| {err_lemg:.3e}, max |logc err| {err_logc:.3e} "
          f"(tolerance: labels > 0.995, rtol 1e-4 / atol 1e-3)", flush=True)
    if not ok:
        _fail("gibbs_fwd disagrees with its plain version")
    ms = _median_ms(lambda: gs.fwd_sweep(*args, **kw), 5)
    plain_ms = _median_ms(lambda: gs.fwd_sweep_plain(*args, K_real=K_real, it_mode=2), 2)
    rows.append(dict(name="gibbs_fwd", route="cuda",
                     source="quilt_tpu_torch/csrc/gibbs_sweep.cu",
                     replaces="quilt_tpu/kernels/gibbs_pallas.py:56",
                     max_abs_err=max(err_lemg, err_logc), ms=ms, plain_ms=plain_ms))

    lemg = got[0]
    trans = args[6]
    got_b = gs.bwd_sweep(lemg, trans, nl=2, K_real=K_real)
    ref_b = gs.bwd_sweep_plain(lemg, trans, K_real)
    err = (got_b - ref_b).abs().max().item()
    print(f"gibbs_bwd: max |beta err| {err:.3e} (tolerance rtol 1e-5, atol 1e-6)", flush=True)
    if not torch.allclose(got_b, ref_b, rtol=1e-5, atol=1e-6):
        _fail("gibbs_bwd disagrees with its plain version")
    rows.append(dict(name="gibbs_bwd", route="cuda",
                     source="quilt_tpu_torch/csrc/gibbs_sweep.cu",
                     replaces="quilt_tpu/kernels/gibbs_pallas.py:351",
                     max_abs_err=err,
                     ms=_median_ms(lambda: gs.bwd_sweep(lemg, trans, nl=2, K_real=K_real), 5),
                     plain_ms=_median_ms(lambda: gs.bwd_sweep_plain(lemg, trans, K_real), 2)))

    # Gibbs dosages at the same shape: the sweep's alphas and beta, and
    # random packed subset words [G, B, K] (pad columns >= K_real masked)
    alphas, beta_d = got[1], got_b
    words_T = torch.randint(-2**31, 2**31 - 1, (G, B, K), generator=gen, device="cuda",
                            dtype=torch.int64).to(torch.int32)
    eps = 0.001
    hd = gd.dosage_sweep(alphas, beta_d, words_T, 2, K_real, eps)
    hd_r = gd.dosage_sweep_plain(alphas, beta_d, words_T, K_real, eps)
    err = (hd - hd_r).abs().max().item()
    print(f"gibbs_dos: max |dosage err| {err:.3e} (tolerance atol 1e-5)", flush=True)
    if not err <= 1e-5:
        _fail("gibbs_dos disagrees with its plain version")
    rows.append(dict(name="gibbs_dos", route="cuda",
                     source="quilt_tpu_torch/csrc/gibbs_dosage.cu",
                     replaces="quilt_tpu/kernels/gibbs_pallas.py:420",
                     max_abs_err=err,
                     ms=_median_ms(lambda: gd.dosage_sweep(alphas, beta_d, words_T, 2, K_real, eps), 5),
                     plain_ms=_median_ms(lambda: gd.dosage_sweep_plain(alphas, beta_d, words_T, K_real, eps), 2)))

    # full-panel FB at the e2e shape: B = 56 chains x 2 latent haps
    fb = world["fb"]
    dev = fb.device_tensors("cuda")
    words, trans2, thin = dev["words"], dev["trans2"], dev["thin_flag"]
    Bf = 112
    gl = 0.05 + 0.95 * torch.rand((Bf, 2, fb.S), generator=gen, device="cuda")
    t0 = gl[:, 0] * (1 - eps) + gl[:, 1] * eps
    t1 = gl[:, 0] * eps + gl[:, 1] * (1 - eps)
    dl = (torch.log(t1) - torch.log(t0)).contiguous()
    ck, lg = fbk.fb_forward(dl, words, trans2, fb.K)
    ck_r, lg_r = fbk.fb_forward_plain(dl, words, trans2, fb.K)
    err_ck = (ck - ck_r).abs().max().item()
    err_lg = (lg - lg_r).abs().max().item()
    print(f"fb_fwd: max |alpha ckpt err| {err_ck:.3e}, max |loglik err| {err_lg:.3e} "
          f"(|loglik| up to {lg_r.abs().max().item():.1f}; tolerance ckpt atol 1e-5, "
          f"loglik rtol 1e-5 + atol 1e-2)", flush=True)
    if err_ck > 1e-5 or not torch.allclose(lg, lg_r, rtol=1e-5, atol=1e-2):
        _fail("fb_fwd disagrees with its plain version")
    rows.append(dict(name="fb_fwd", route="cuda", source="quilt_tpu_torch/csrc/fb.cu",
                     replaces="quilt_tpu/kernels/fb_pallas.py:106", max_abs_err=err_ck,
                     ms=_median_ms(lambda: fbk.fb_forward(dl, words, trans2, fb.K), 5),
                     plain_ms=_median_ms(lambda: fbk.fb_forward_plain(dl, words, trans2, fb.K), 2)))

    K_top = 8
    d, tv, ti = fbk.fb_backward(dl, words, ck, trans2, thin, fb.K, K_top, eps)
    d_r, tv_r, ti_r = fbk.fb_backward_plain(dl, words, ck, trans2, thin, fb.K, K_top, eps)
    err_d = (d - d_r).abs().max().item()
    err_tv = (tv - tv_r).abs().max().item()
    g = thin >= 0
    firm = (tv_r[g][:, :, :-1] - tv_r[g][:, :, 1:]) > 1e-3
    idx_ok = bool((ti[g][:, :, :-1][firm] == ti_r[g][:, :, :-1][firm]).all())
    print(f"fb_bwd: max |dosage err| {err_d:.3e}, max |top-K value err| {err_tv:.3e}, "
          f"top-K indices equal where gap > 1e-3: {idx_ok} "
          f"(tolerance dosage / top-K atol 1e-4)", flush=True)
    if err_d > 1e-4 or err_tv > 1e-4 or not idx_ok:
        _fail("fb_bwd disagrees with its plain version")
    rows.append(dict(name="fb_bwd", route="cuda", source="quilt_tpu_torch/csrc/fb.cu",
                     replaces="quilt_tpu/kernels/fb_pallas.py:151", max_abs_err=err_d,
                     ms=_median_ms(lambda: fbk.fb_backward(dl, words, ck, trans2, thin, fb.K, K_top, eps), 5),
                     plain_ms=_median_ms(lambda: fbk.fb_backward_plain(dl, words, ck, trans2, thin, fb.K, K_top, eps), 2)))
    for r in rows:
        print(f"  {r['name']}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms", flush=True)
    return rows


# ---------------------------------------------------------------------------
# the full-width world (phase 3 imputes it; phase 2 takes its shapes)
# ---------------------------------------------------------------------------

def e2e_config(n_samples, quilt2=False):
    """QUILT1 defaults at the quick-start scale: 7 chains x 3 seek
    iterations x 21 sweeps, Ksubset 600, all samples in one batch; quilt2
    adds the QUILT2 defaults use_mspbwt and impute_rare_common."""
    from quilt_tpu_torch.engine.driver import ImputeConfig

    return ImputeConfig(
        nGibbsSamples=7, n_seek_its=3, Ksubset=600, Knew=600,
        small_ref_panel_gibbs_iterations=20, seed=1, sample_batch=n_samples,
        override_default_params_for_small_ref_panel=False,
        print_extra_timing_information=True, verbose=False,
        use_mspbwt=quilt2, impute_rare_common=quilt2,
    )


def make_world(n_samples=8, K=5120, nSNPs=16384, quilt2=False):
    """The full-width world; quilt2 rewrites 10% of the sites to 1-4
    carriers and prepares the panel as `prepare2` does."""
    import numpy as np
    from quilt_tpu_torch.inputs import region_tensors
    from quilt_tpu_torch.simulate import make_world as simulate

    t = time.time()
    world = simulate(np.random.default_rng(SEED), K=K, nSNPs=nSNPs, n_samples=n_samples,
                     rare_frac=0.1 if quilt2 else 0.0, quilt2=quilt2)
    prep = world["prep"]
    W = max(int(np.bincount(r.wif0, minlength=r.wif0.max() + 1).max())
            for r in world["samples"])
    world.update(nGrids=prep.nGrids, max_reads_per_grid=W)
    if not quilt2:
        world["fb"] = region_tensors(prep, e2e_config(n_samples), "cuda")["fb"]
    rare = "" if not quilt2 else (
        f", {int((~prep.snp_is_common).sum())} rare sites held out of "
        f"{prep.nGrids} common grids, {len(prep.ms_indices)} msPBWT indices")
    print(f"world: K={K}, nSNPs={nSNPs}, nGrids={prep.nGrids}{rare}, {n_samples} samples, "
          f"{sum(r.nReads for r in world['samples'])} reads, max reads/grid {W} "
          f"({time.time() - t:.1f} s to simulate and prepare)", flush=True)
    return world


# ---------------------------------------------------------------------------
# phases 3 and 4: full-width end-to-end imputation through the port's engine
# ---------------------------------------------------------------------------

def run_e2e(world, kernels, cfg, label):
    """A warm-up call (it builds the region context, cached on the prepared
    reference), then a timed call with every launch count set to 0 just
    before it. Returns (output, seconds, {kernel entry: launches})."""
    import numpy as np
    import torch
    from quilt_tpu_torch.engine.driver import quilt_impute

    samples = world["samples"]
    names = [f"S{i}" for i in range(len(samples))]
    truth_gen = np.stack([t.sum(axis=0) for t in world["truths"]], axis=1).astype(float)
    quilt_impute(world["prep"], samples, names, cfg, "cuda")
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t = time.time()
    out = quilt_impute(world["prep"], samples, names, cfg, "cuda", truth_gen=truth_gen)
    torch.cuda.synchronize()
    dt = time.time() - t
    launches = {k.entry: k.launches for k in kernels}
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
    return out, truth_gen, launches


def check_launched(label, launches, needed):
    missing = [k.entry for k in needed if not launches[k.entry]]
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


# ---------------------------------------------------------------------------
# phase 5: file-based prepare + impute (QUILT1, QUILT2) through the port's CLI
# ---------------------------------------------------------------------------

def run_cli():
    import gzip
    import tempfile

    import numpy as np
    from quilt_tpu_torch.simulate import write_bam_world

    small = ["--nGibbsSamples", "3", "--n_seek_its", "2", "--Ksubset", "48", "--Knew", "48",
             "--small_ref_panel_gibbs_iterations", "8", "--verbose", "FALSE"]
    for prepare, impute, extra, n_rare in (
        ("prepare", "impute", [], 0),
        ("prepare2", "impute2", ["--rare_af_threshold", "0.03"], 24),
    ):
        with tempfile.TemporaryDirectory() as d:
            vcf, gmap, bamlist, truths, nSNPs = write_bam_world(
                d, np.random.default_rng(SEED), n_rare=n_rare)
            out = os.path.join(d, "out")
            base = [sys.executable, "-m", "quilt_tpu_torch"]
            for args in (
                [prepare, "--outputdir", out, "--chr", "chr20", "--reference_vcf_file", vcf,
                 "--genetic_map_file", gmap, "--nGen", "100"] + extra,
                [impute, "--outputdir", out, "--chr", "chr20", "--bamlist", bamlist] + small,
            ):
                res = subprocess.run(base + args, cwd=HERE, capture_output=True, text=True,
                                     timeout=600)
                if res.returncode != 0:
                    _fail(f"CLI {args[0]} exited {res.returncode}:\n{res.stderr[-3000:]}")
            with gzip.open(os.path.join(out, "quilt.chr20.vcf.gz"), "rt") as fh:
                lines = fh.readlines()
        body = [l for l in lines if not l.startswith("#")]
        r2 = []
        for i, truth in enumerate(truths):
            ds = np.array([float(l.split("\t")[9 + i].split(":")[2]) for l in body])
            r2.append(float(np.corrcoef(ds, truth.sum(axis=0))[0, 1] ** 2))
        print(f"cli: {prepare} + {impute} wrote {len(body)} of {nSNPs} sites; r2 {r2}",
              flush=True)
        if len(body) != nSNPs or min(r2) < 0.85:
            _fail(f"CLI {impute} VCF is incomplete or inaccurate")


def main():
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    world = make_world()
    rows = check_kernels(world)
    from quilt_tpu_torch.kernels import fb, gibbs_dosage, gibbs_sweep

    gfwd, gbwd, gdos = gibbs_sweep.FWD_KERNEL, gibbs_sweep.BWD_KERNEL, gibbs_dosage.DOS_KERNEL
    kernels = [gfwd, gbwd, gdos, fb.FWD_KERNEL, fb.BWD_KERNEL]   # the order of rows
    out, _, l1 = run_e2e(world, kernels, e2e_config(8), "e2e")
    if min(out.r2_per_sample) < 0.9:
        _fail(f"e2e r2 against truth below 0.9: {out.r2_per_sample}")
    check_launched("e2e", l1, [gfwd, gbwd, fb.FWD_KERNEL, fb.BWD_KERNEL])
    del world

    world2 = make_world(quilt2=True)
    out, truth_gen, l2 = run_e2e(world2, kernels, e2e_config(8, quilt2=True), "quilt2")
    quilt2_report(world2, out, truth_gen)
    if min(out.r2_per_sample) < 0.85:
        _fail(f"quilt2 r2 over all sites below 0.85: {out.r2_per_sample}")
    check_launched("quilt2", l2, [gfwd, gbwd, gdos])
    del world2
    for row, k in zip(rows, kernels):
        row["launches"] = l1[k.entry] + l2[k.entry]
        row["launches_by_path"] = {"quilt1": l1[k.entry], "quilt2": l2[k.entry]}
    run_cli()

    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
