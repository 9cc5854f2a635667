#!/usr/bin/env python3
"""Holds the Gibbs-side CUDA kernels of this checkout against a parent's.

    python3 parent_parity.py PARENT_DIR

PARENT_DIR is a checkout of the commit to compare with (for example one
unpacked with `git archive`). Both checkouts' kernels are built from their
own sources, and the parent's package is loaded under another name. Every
form of the two Gibbs sweeps and of the NIPT bank that the parent runs is
launched through both packages' wrappers on the same random state (the
smoke run's table shape, G = 512, 56 chains, K = 640 of which 600 real, and
the forms' last K; the backward's global form at 10,368 and 16,512), and
the outputs must be equal bit for bit: a change that only adds forms for
other widths leaves these launches as they were. The default forms are
then timed in turn (4 rounds of 7 launches, CUDA events), the backward
also at 32 grids x 16 state rows x 10,368. Needs one CUDA card; exits
non-zero on any difference.
"""
from __future__ import annotations

import importlib
import importlib.util
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
SEED = 20260117


def _load(root: Path, name: str):
    """The quilt_tpu_torch package of checkout `root` as module `name`."""
    pkg = root / "quilt_tpu_torch"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _median_ms(fn, n=7):
    import torch

    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _in_turn(fns, rounds=4):
    times = {k: [] for k in fns}
    for r in range(rounds):
        for k in (list(fns) if r % 2 == 0 else reversed(list(fns))):
            times[k].append(_median_ms(fns[k]))
    return {k: statistics.median(v) for k, v in times.items()}


def _same(a, b):
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    return len(a) == len(b) and all(x.shape == y.shape and x.dtype == y.dtype
                                    and bool(((x == y) | (x.isnan() & y.isnan())).all())
                                    for x, y in zip(a, b))


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__.strip().split("\n\n")[1], file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    parent_root = Path(sys.argv[1]).resolve()
    new = _load(HERE, "new_quilt")
    old = _load(parent_root, "parent_quilt")
    with ThreadPoolExecutor(2) as pool:      # both checkouts' nvcc runs at once
        list(pool.map(lambda p: importlib.import_module(f"{p.__name__}._build").build_all(
            ["gibbs_sweep", "nipt_bank"]), (new, old)))
    gs_new, gs_old = (importlib.import_module(f"{p.__name__}.kernels.gibbs_sweep")
                      for p in (new, old))
    nb_new, nb_old = (importlib.import_module(f"{p.__name__}.kernels.nipt_bank")
                      for p in (new, old))
    sim = importlib.import_module("new_quilt.simulate")
    failed = []

    def check(label, f_new, f_old):
        ok = _same(f_new(), f_old())
        print(f"{label}: {'equal bit for bit' if ok else 'DIFFERENT'}", flush=True)
        if not ok:
            failed.append(label)

    # the sweeps: every variant the smoke run launches at the table shape,
    # and each form at its last K (G = 16 grids, 4 chains there; the
    # forward's general variant at nl = 3 holds K up to 8,155 only)
    shapes = [(512, 56, 12, 640, 600, None)] + [
        (16, 4, 4, k, k - 40, v) for k, v in ((2048, None), (10240, -1), (8064, -1))]
    for G, B, W, K, K_real, only in shapes:
        for nl in (2, 3):
            if K == 8064 and nl == 2:
                continue
            prior = (0.5, 0.5) if nl == 2 else (0.5, 0.45, 0.05)
            args = [torch.from_numpy(x).cuda() for x in sim.random_sweep_state(
                np.random.default_rng(SEED + K + nl), G, B, W, K, K_real, W, nl=nl)]
            kw = dict(nl=nl, K_real=K_real, it_mode=2, prior=prior)
            fwd_forms = ([dict()] if only is None else [dict(_variant=only)]) + (
                [dict(_variant=v) for v in (64, 128, 256, -1)] if K == 640 else [])
            if K == 640 and nl == 3:
                fwd_forms.append(dict(_wide=True))
            for f in fwd_forms:
                if nl == 3 and (K == 10240 or K == 640 and f.get("_variant") in (64, 128)):
                    continue
                check(f"gibbs_fwd nl={nl} K={K} {f or 'default'}",
                      lambda f=f: gs_new.fwd_sweep(*args, **kw, **f),
                      lambda f=f: gs_old.fwd_sweep(*args, **kw, **f))
            lemg, trans = args[0], args[6]
            bwd_forms = [dict()] + ([dict(_variant=v) for v in (64, 128, 256, -1)]
                                    + [dict(_variant=128, _ahead=True)]
                                    if K == 640 else [])
            for f in bwd_forms:
                check(f"gibbs_bwd nl={nl} K={K} {f or 'default'}",
                      lambda f=f: gs_new.bwd_sweep(lemg, trans, nl=nl, K_real=K_real, **f),
                      lambda f=f: gs_old.bwd_sweep(lemg, trans, nl=nl, K_real=K_real, **f))
            if K == 640:
                t = _in_turn({
                    "fwd parent": lambda: gs_old.fwd_sweep(*args, **kw),
                    "fwd change": lambda: gs_new.fwd_sweep(*args, **kw),
                    "bwd parent": lambda: gs_old.bwd_sweep(lemg, trans, nl=nl, K_real=K_real),
                    "bwd change": lambda: gs_new.bwd_sweep(lemg, trans, nl=nl, K_real=K_real)})
                print(f"timed in turn at nl={nl}, G={G}, B={B}, K={K}: "
                      + ", ".join(f"{k} {v:.3f} ms" for k, v in t.items()), flush=True)

    # the backward's global form at any K (the parent's only form past
    # 10,240), and the default backward (this checkout's cluster form where
    # bwd_form takes it) timed in turn with the parent's at the timing shape,
    # 32 grids x 16 state rows x 10,368
    for K in (10368, 16512):
        G, BN = 32, 16
        lemg = -20.0 * torch.rand((G, BN, K), generator=torch.Generator(device="cuda")
                                  .manual_seed(SEED + K), device="cuda")
        trans = torch.tensor([[0.98], [0.02]], device="cuda").repeat(1, G)
        trans[:, 0] = torch.tensor([1.0, 0.0], device="cuda")
        check(f"gibbs_bwd global form K={K}",
              lambda: gs_new.bwd_sweep(lemg, trans, nl=2, K_real=K - 68, _variant=-2),
              lambda: gs_old.bwd_sweep(lemg, trans, nl=2, K_real=K - 68, _variant=-2))
        if K == 10368:
            t = _in_turn({"parent": lambda: gs_old.bwd_sweep(lemg, trans, nl=2, K_real=K - 68),
                          "change": lambda: gs_new.bwd_sweep(lemg, trans, nl=2, K_real=K - 68)})
            print(f"gibbs_bwd default timed in turn at G={G}, rows={BN}, K={K} (change: form "
                  f"{gs_new.bwd_form(K)}): "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in t.items()), flush=True)

    # the bank: each form the wrapper takes (<2> at 256, <5> at 640, <8> at
    # 1,024, the general form at 3,000), 28 chains x 512 grids
    for K in (256, 640, 1024, 3000):
        rng = np.random.default_rng(SEED + K)
        G, B = 512, 28
        lemg, beta = (torch.from_numpy(x).cuda() for x in sim.random_sweep_state(
            rng, G, B, 4, K, K - 24, 4, nl=3)[:2])
        trans = torch.from_numpy(np.stack([np.full(G, 0.98), np.full(G, 0.02)]).astype(np.float32))
        trans[:, 0] = torch.tensor([1.0, 0.0])
        is_end = (rng.random((G, B)) < 12 / G).astype(np.int32)
        is_end[G - 1] = 1
        args = (lemg, beta, trans.cuda(),
                torch.from_numpy(rng.normal(0, 2, (G, B, 6)).astype(np.float32)).cuda(),
                torch.from_numpy(rng.random((G, B)).astype(np.float32)).cuda(),
                torch.from_numpy(is_end).cuda(), torch.ones(6, device="cuda"), K - 24)
        check(f"nipt_bank K={K} (form {nb_new.bank_form(K, G)})",
              lambda: nb_new.bank_scan(*args), lambda: nb_old.bank_scan(*args))
        if K == 640:
            t = _in_turn({"parent": lambda: nb_old.bank_scan(*args),
                          "change": lambda: nb_new.bank_scan(*args)})
            print(f"nipt_bank timed in turn at G={G}, B={B}, K={K}: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in t.items()), flush=True)

    if failed:
        print(f"FAILED: {failed}", flush=True)
        return 1
    print("parity: every form the parent runs gives the same bits", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
