"""Multi-host execution of the port on the CPU (quilt_tpu_torch.dist.hosts
over torch.distributed / gloo): the sample shards against the JAX
package's, the collectives in a real 2-process world against what one
process computes, the CLI run as two processes against one
(tests/test_dist_hosts.py's check: sample columns bit for bit, INFO within
1e-3 of |value|), and the build lock that keeps two processes from
building one library at once."""
import gzip
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from quilt_tpu.dist.hosts import sample_shards as jax_sample_shards

from quilt_tpu_torch import _build, cli
from quilt_tpu_torch.dist.hosts import sample_shards
from quilt_tpu_torch.simulate import write_bam_world

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(code: str, nproc: int, timeout: int, args=()):
    """Runs `code` in nproc Python processes (rank as sys.argv[1], then
    args), 2 torch threads each; returns their (stdout, stderr)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), *args], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-4000:]
            outs.append((out, err))
    finally:
        for p in procs:
            p.kill()
    return outs


@pytest.mark.parametrize("N,nproc", [(4, 2), (5, 2), (1, 2), (10, 3), (7, 4)])
def test_sample_shards_match_jax(N, nproc):
    got, ref = sample_shards(N, nproc), jax_sample_shards(N, nproc)
    assert len(got) == len(ref) == nproc
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


COLLECTIVES = """
import json, sys
import numpy as np
from quilt_tpu_torch.dist.hosts import (allgather_columns, init_multihost,
                                        reduce_sum_across_hosts, sample_shards)
rank, port = int(sys.argv[1]), sys.argv[2]
init_multihost(f"localhost:{port}", 2, rank)
rng = np.random.default_rng(rank)
red = reduce_sum_across_hosts({"f": rng.random((5, 3)), "i": rng.integers(0, 9, (4, 2)),
                               "n": np.array(rank + 1, dtype=np.int64)})
cols = {}
for N in (3, 1):   # with N = 1 process 1's shard is empty
    local = {int(i): [f"{i}:{j}" for j in range(4)] for i in sample_shards(N, 2)[rank]}
    cols[N] = allgather_columns(local, N)
print(json.dumps({"f": red["f"].tolist(), "i": red["i"].tolist(), "idt": str(red["i"].dtype),
                  "n": int(red["n"]), "cols": cols}))
import torch.distributed
torch.distributed.destroy_process_group()
"""


def test_collectives_in_a_two_process_world():
    outs = [json.loads(o) for o, _ in _run_ranks(COLLECTIVES, 2, 300, (str(_free_port()),))]
    draws = [np.random.default_rng(r) for r in range(2)]
    f = [d.random((5, 3)) for d in draws]
    i = [d.integers(0, 9, (4, 2)) for d in draws]
    for out in outs:    # every process gets the same sums and columns
        np.testing.assert_array_equal(out["f"], f[0] + f[1])
        np.testing.assert_array_equal(out["i"], i[0] + i[1])
        assert out["idt"] == "int64" and out["n"] == 3
        for N in (3, 1):
            assert out["cols"][str(N)] == [[f"{s}:{j}" for j in range(4)] for s in range(N)]


IMPUTE = """
import sys
import torch
torch.set_num_threads(2)
from quilt_tpu_torch.cli import main
argv = sys.argv[2:]
if "--distributed_nproc" in argv:
    argv += ["--distributed_rank", sys.argv[1]]
sys.exit(main(argv, device="cpu"))
"""


def _vcf_body(path):
    with gzip.open(path, "rt") as fh:
        return [line.rstrip("\n").split("\t") for line in fh if not line.startswith("##")]


def test_cli_two_processes_match_one(tmp_path):
    vcf, gmap, bamlist, _, _ = write_bam_world(str(tmp_path), np.random.default_rng(5),
                                               n_samples=4, nSNPs=256)
    prep_dir = str(tmp_path / "prep")
    assert cli.main(["prepare", "--outputdir", prep_dir, "--chr", "chr20",
                     "--reference_vcf_file", vcf, "--genetic_map_file", gmap,
                     "--nGen", "100"]) == 0
    prepared = os.path.join(prep_dir, "RData", "QUILT_prepared_reference.chr20.npz")

    def args(out):
        return ["impute", "--outputdir", str(tmp_path / out), "--chr", "chr20",
                "--bamlist", bamlist, "--prepared_reference_filename", prepared,
                "--nGibbsSamples", "2", "--n_seek_its", "2", "--Ksubset", "40", "--Knew", "30",
                "--small_ref_panel_gibbs_iterations", "4", "--sample_batch", "2",
                "--seed", "11"]

    _run_ranks(IMPUTE, 1, 300, args("one"))
    dist = ["--distributed_nproc", "2", "--distributed_coordinator", f"localhost:{_free_port()}"]
    errs = [e for _, e in _run_ranks(IMPUTE, 2, 300, args("two") + dist)]
    assert "process 1/2 imputes 2/4 samples" in errs[1]
    one = _vcf_body(str(tmp_path / "one" / "quilt.chr20.vcf.gz"))
    two = _vcf_body(str(tmp_path / "two" / "quilt.chr20.vcf.gz"))
    assert len(one) == len(two) > 200
    for a, b in zip(one, two):
        # sample columns bit for bit: each sample is imputed by exactly one
        # process, with the seed of the same batch
        assert a[:7] == b[:7] and a[8:] == b[8:], (a, b)
        # INFO aggregates: the allgather-then-sum reassociates the float sums
        if a[7] != b[7]:
            for kv1, kv2 in zip(a[7].split(";"), b[7].split(";")):
                k1, v1 = kv1.split("=")
                k2, v2 = kv2.split("=")
                assert k1 == k2
                assert abs(float(v1) - float(v2)) < 1e-3 * max(1.0, abs(float(v1))), (kv1, kv2)


def test_build_lock_takes_turns(tmp_path, monkeypatch):
    """Two threads asking for one source's build lock hold it one after the
    other (flock on separate opens of the lock file conflicts, as between
    processes)."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    spans = []

    def hold():
        with _build.build_lock("fb_sharded"):
            t = time.monotonic()
            time.sleep(0.3)
            spans.append((t, time.monotonic()))

    threads = [threading.Thread(target=hold) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert len(spans) == 2 and (tmp_path / "fb_sharded.lock").exists()
    (a0, a1), (b0, b1) = sorted(spans)
    assert b0 >= a1
