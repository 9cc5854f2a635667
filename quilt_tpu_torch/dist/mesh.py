"""Multi-device execution in one process: the device mesh, the panel-sharded
full-panel FB and the chain-sharded Gibbs call.

The port of quilt_tpu/dist/mesh.py. A mesh is an [n_data, n_panel] array of
torch devices (make_mesh; a device may repeat, so every shard can also be
placed on one card):

- `data` axis: independent rows (FB rows, Gibbs chains) batch-parallel;
- `panel` axis: the K haplotypes of the full-panel FB split over the
  devices of a data row. The segment-fused body (kernels/fb_sharded.py)
  exchanges a few sums a row once a segment of 8 grids; a PanelGroup does
  the exchange: it sums (or maxes) the shards' partial tensors in shard
  order on the row's first device and sends the one result back to each, so
  every shard computes on the same bits. On separate cards the copies are
  peer copies.

The JAX package splits the distinct-haplotype table and the escape COO of
its XLA body over the shards; the port's FB reads the packed panel words,
so a panel shard is a block of columns of FBInputs.words.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..inputs import FBInputs, pad_to_multiple
from ..kernels.fb_sharded import PanelShard, on_device, sharded_core
from ..kernels.gibbs import GibbsCall, run_gibbs_chains
from ..utils import print_message


def as_device(d) -> torch.device:
    """torch.device(d), with "cuda" taken as the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def default_devices(device=None) -> List[torch.device]:
    """The visible cards, starting at `device` (default: the current card),
    so that processes sharing a host's cards start their meshes on their
    own card; [device] for a CPU device (default on a machine with no
    card)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = as_device(device)
    if device.type != "cuda":
        return [device]
    n = torch.cuda.device_count()
    return [torch.device("cuda", (device.index + i) % n) for i in range(n)]


def make_mesh(n_data: int, n_panel: int, devices: Optional[Sequence] = None) -> np.ndarray:
    """[n_data, n_panel] array of torch devices: the first n_data x n_panel
    of `devices` (default: the visible cards), row-major. A device may
    repeat."""
    devices = [as_device(d) for d in (devices if devices is not None else default_devices())]
    if len(devices) < n_data * n_panel:
        raise ValueError(f"need {n_data * n_panel} devices, have {len(devices)}")
    mesh = np.empty((n_data, n_panel), dtype=object)
    for i, d in enumerate(devices[:n_data * n_panel]):
        mesh[i // n_panel, i % n_panel] = d
    return mesh


def mesh_from_config(cfg, devices: Optional[Sequence] = None) -> Optional[np.ndarray]:
    """The engine's mesh from ImputeConfig.mesh_data / mesh_panel; None when
    the config asks for one device. Raises ValueError when the mesh needs
    more devices than `devices` (default: the visible cards) holds."""
    n_data = max(int(getattr(cfg, "mesh_data", 1) or 1), 1)
    n_panel = max(int(getattr(cfg, "mesh_panel", 1) or 1), 1)
    if n_data * n_panel <= 1:
        return None
    devices = list(devices) if devices is not None else default_devices()
    if n_data * n_panel > len(devices):
        raise ValueError(f"mesh_data x mesh_panel = {n_data}x{n_panel} needs "
                         f"{n_data * n_panel} devices; only {len(devices)} available")
    return make_mesh(n_data, n_panel, devices)


class PanelGroup:
    """The panel axis of one data row of the mesh. `exchanges` counts the
    sums and maxima."""

    def __init__(self, devices: Sequence):
        self.devices = [as_device(d) for d in devices]
        self.exchanges = 0

    def broadcast(self, t: torch.Tensor) -> List[torch.Tensor]:
        """t on each shard's device (the same tensor where it already lies)."""
        return [t if t.device == d else t.to(d) for d in self.devices]

    def _reduce(self, parts, op) -> List[torch.Tensor]:
        home = self.devices[0]
        acc = parts[0].to(home)
        for p in parts[1:]:
            acc = op(acc, p.to(home))
        self.exchanges += 1
        return self.broadcast(acc)

    def sum(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The sum of the shards' tensors, in shard order, on each device."""
        return self._reduce(parts, torch.add)

    def max(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The elementwise maximum of the shards' tensors on each device."""
        return self._reduce(parts, torch.maximum)

    def gather(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The shards' tensors on the first device, in shard order."""
        return [p.to(self.devices[0]) for p in parts]


class ShardedFB:
    """Per-region state of the panel-sharded FB: each data row's panel
    shards (a block of K_shard columns of the packed panel, K_shard a
    multiple of 128, on that row's devices), uploaded once and reused across
    calls (the sharded counterpart of FBInputs.device_tensors)."""

    def __init__(self, inputs: FBInputs, mesh: np.ndarray, K_top: int = 8,
                 ref_error: float = 0.001):
        self.inputs = inputs
        self.mesh = mesh
        self.K_top = K_top
        self.ref_error = ref_error
        self.n_data, self.n_panel = mesh.shape
        K_shard = pad_to_multiple(-(-inputs.K_pad // self.n_panel), 128)
        self.K_shard = K_shard
        words = np.zeros((inputs.nGrids, self.n_panel * K_shard), dtype=np.int32)
        words[:, :inputs.K_pad] = inputs.words
        trans2 = np.ascontiguousarray(inputs.trans.T)
        self.rows = []
        for d in range(self.n_data):
            group = PanelGroup(mesh[d])
            shards = [PanelShard(
                words=torch.as_tensor(np.ascontiguousarray(words[:, p * K_shard:(p + 1) * K_shard]),
                                      device=dev),
                trans2=torch.as_tensor(trans2, device=dev),
                thin=torch.as_tensor(inputs.thin_flag, device=dev),
                K_loc=int(np.clip(inputs.K - p * K_shard, 0, K_shard)), k0=p * K_shard,
            ) for p, dev in enumerate(group.devices)]
            self.rows.append((group, shards))

    @property
    def exchanges(self) -> int:
        return sum(g.exchanges for g, _ in self.rows)

    def __call__(self, gl):
        """gl [B, 2, nSNPs or S] (tensor, or NumPy array: then the outputs
        lie on the mesh's first device). Returns on gl's device (dosage [B,
        nSNPs], log_like [B], tv / ti [Gp, B, K_top x n_panel]: the per-shard
        top-K lists merged by value, zero-gamma slots at haplotype 0) and,
        with a capture grid, gcap [B, K]. The batch is padded to a multiple
        of the data axis with gl = 1 and split into contiguous blocks, one
        per data row."""
        inp = self.inputs
        if not isinstance(gl, torch.Tensor):
            gl = torch.as_tensor(np.asarray(gl, dtype=np.float32), device=self.mesh[0, 0])
        home = gl.device
        B = gl.shape[0]
        per = -(-B // self.n_data)
        gl_pad = torch.ones((per * self.n_data, 2, inp.S), dtype=torch.float32, device=home)
        gl_pad[:B, :, :gl.shape[2]] = gl
        parts = []
        for d, (group, shards) in enumerate(self.rows):
            rows = gl_pad[d * per:(d + 1) * per].to(group.devices[0])
            with on_device(group.devices[0]):
                parts.append([x.to(home) for x in sharded_core(
                    rows, shards, group, inp.K, self.K_top, self.ref_error, inp.capture_grid)])
        out = [torch.cat([p[i] for p in parts], dim=1 if i in (2, 3) else 0)
               for i in range(len(parts[0]))]
        res = (out[0][:B, :inp.nSNPs], out[1][:B], out[2][:, :B], out[3][:, :B])
        if inp.capture_grid >= 0:
            res = res + (out[4][:B, :inp.K],)
        return res


def fb_full_sharded(gl, inputs: FBInputs, mesh: np.ndarray, K_top: int = 8,
                    ref_error: float = 0.001):
    """One-shot wrapper (tests, checks); the engine holds a ShardedFB."""
    return ShardedFB(inputs, mesh, K_top=K_top, ref_error=ref_error)(gl)


_NOT_SPLIT_LOGGED = set()


def shard_gibbs_batch(mesh: np.ndarray, layout, trans, lem, skip, uniforms, H0, first_read,
                      iterative_init, K_real, block_u=None, resample_u=None, relabel_u=None,
                      words=None, smooth_w=None, boundaries=None, **kw) -> GibbsCall:
    """kernels.gibbs.run_gibbs_chains with the chain axis split over the
    mesh: into one contiguous block per device when the batch divides every
    device of the mesh, else one per data row (its first device) when it
    divides the data axis, else not at all (logged once per batch size).
    Chains are independent, so the blocks run with no exchange: each on its
    device, from the slices of the inputs drawn for the whole batch (the
    uniforms are drawn once, as on one device), and the results are
    gathered back to lem's device."""
    B = lem.shape[0]
    n_data = mesh.shape[0]
    if B % mesh.size == 0:
        devs = list(mesh.flat)
    elif B % n_data == 0:
        devs = list(mesh[:, 0])
    else:
        if B not in _NOT_SPLIT_LOGGED:
            _NOT_SPLIT_LOGGED.add(B)
            print_message(f"Gibbs batch of {B} chains divides neither the mesh's "
                          f"{mesh.size} devices nor its {n_data} data rows: not split")
        return run_gibbs_chains(layout, trans, lem, skip, uniforms, H0, first_read,
                                iterative_init, K_real, block_u=block_u, resample_u=resample_u,
                                relabel_u=relabel_u, words=words, smooth_w=smooth_w,
                                boundaries=boundaries, **kw)
    home = lem.device
    per = B // len(devs)
    calls = []
    for i, dev in enumerate(devs):
        def cut(t, axis=0):
            return None if t is None else t.narrow(axis, i * per, per).to(dev).contiguous()

        with on_device(dev):
            calls.append(run_gibbs_chains(
                layout.rows(i * per, (i + 1) * per, dev), trans.to(dev), cut(lem), cut(skip),
                cut(uniforms, 1), cut(H0), cut(first_read), iterative_init, K_real,
                block_u=cut(block_u, 3), resample_u=cut(resample_u, 1),
                relabel_u=cut(relabel_u, 1), words=cut(words),
                smooth_w=None if smooth_w is None else tuple(t.to(dev) for t in smooth_w),
                boundaries=None if boundaries is None else boundaries.to(dev), **kw))
    return GibbsCall(*[
        None if f[0] is None else torch.cat([x.to(home) for x in f], dim=1 if n == "per_it" else 0)
        for n, f in zip(GibbsCall._fields, zip(*calls))])
