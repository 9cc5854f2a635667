"""Multi-host (multi-process) execution: samples are data-parallel across
processes.

The port of quilt_tpu/dist/hosts.py over torch.distributed. The processes
join one gloo group (init_multihost); each reads its own BAM shard on the
host and imputes its contiguous sample shard on its card; then the VCF
aggregates (the INFO / EAF / HWE accumulators) are summed across processes
and the per-sample VCF columns gathered to every process, and process 0
writes the one merged VCF (engine/driver.py). The reduced and gathered data
are host arrays: the collectives run over gloo on CPU tensors, whatever
card a process imputes on.

As in the JAX package a reduction is an allgather followed by a sum over the
process axis, so every process gets the same bits and the INFO fields do not
depend on the rank. Every process takes part in every collective, also one
whose shard is empty (N < nproc).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

DEFAULT_COORDINATOR = "localhost:12321"


def init_multihost(coordinator: str, num_processes: int, process_id: int) -> None:
    """Joins the gloo process group of `num_processes` processes at
    tcp://coordinator (host:port of a port that process 0 can bind)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def process_info() -> Tuple[int, int]:
    """(this process's rank, number of processes): (0, 1) outside a group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def sample_shards(N: int, nproc: int) -> List[np.ndarray]:
    """Contiguous balanced sample shards, one per process."""
    return [np.asarray(s, dtype=int) for s in np.array_split(np.arange(N), nproc)]


def _allgather(x: np.ndarray) -> np.ndarray:
    """[nproc, *x.shape]: x of every process, in rank order."""
    import torch.distributed as dist

    x = np.ascontiguousarray(x)
    t = torch.from_numpy(x.reshape(-1))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return np.stack([o.numpy().reshape(x.shape) for o in out])


def reduce_sum_across_hosts(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Elementwise sum of each named array over all processes (integer
    dtypes kept)."""
    out = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        g = _allgather(v)
        out[k] = g.sum(axis=0).astype(v.dtype) if v.dtype.kind in "iu" else g.sum(axis=0)
    return out


def allgather_columns(local_columns: Dict[int, List], N: int) -> List[Optional[List[str]]]:
    """Gathers the per-sample VCF column lists of every process.

    local_columns maps a GLOBAL sample index to its list of per-SNP cells
    (str or bytes). Returns the full N-length list on every process.
    Cells are ASCII without NUL or newline, so a process's samples travel
    as one blob of index-prefixed, NUL-joined columns, padded to the
    longest blob."""
    parts = []
    for i in sorted(local_columns):
        cells = [c if isinstance(c, bytes) else c.encode() for c in local_columns[i]]
        parts.append(b"%d\x01" % i + b"\n".join(cells))
    blob = b"\x00".join(parts)
    lens = _allgather(np.array([len(blob)], dtype=np.int64))[:, 0]
    padded = np.zeros(max(int(lens.max()), 1), dtype=np.uint8)
    padded[:len(blob)] = np.frombuffer(blob, dtype=np.uint8)
    blobs = _allgather(padded)
    out: List[Optional[List[str]]] = [None] * N
    for p in range(blobs.shape[0]):
        raw = blobs[p, :int(lens[p])].tobytes().decode()
        if not raw:
            continue
        for part in raw.split("\x00"):
            idx, col = part.split("\x01", 1)
            out[int(idx)] = col.split("\n")
    return out
