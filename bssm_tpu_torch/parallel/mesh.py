"""Device meshes over ``torch.distributed``: chain- and draw-parallel runs.

Counterpart of ``bssm_tpu/parallel/mesh.py``.  The JAX package shards the
arrays of one program over a mesh of devices.  PyTorch runs one process (a
rank) a device, so a mesh here is a ``torch.distributed`` ``DeviceMesh``
over the ranks of the default process group, with the axes ("chains",
"draws"), and ``run_mcmc(mesh=...)`` / ``post_correct(mesh=...)`` split
their rows over it:

  - phase 1: the chains over the first ("chains") axis; the ranks of one
    "chains" coordinate run the same block of chains, as the JAX package
    replicates it over "draws";
  - the IS correction and the state outputs: their rows over the whole
    mesh (the flat axis), cut at jump-chain heads.

A mesh changes where a row runs and nothing else: a rank makes the
unsharded run's generator calls and keeps its rows' draws (``core/rows.py``),
and after the run every rank holds the whole output.  The sharding helpers
keep the JAX package's names; they return what the port uses in place of a
``NamedSharding``, the block of a leading axis a rank owns (``RowSplit``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import resolve_device


def _world_of_one(device: torch.device) -> None:
    """A process group of this process alone, as JAX's single-process mesh:
    a local store, NCCL on a CUDA device, gloo on the CPU."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("chains", "draws"),
              shape: Optional[Sequence[int]] = None, device=None):
    """A ``DeviceMesh`` over the ranks of the default process group, one
    device a rank, on the CUDA device unless ``device="cpu"``.

    With no ``shape``, all ranks go on the first axis and the others are 1.
    Without a process group it starts a world of one.  ``n_devices`` must be
    the world size (a rank is a process, so the mesh takes every one)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        _world_of_one(dev)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"make_mesh: n_devices={n}, but the process group "
                         f"has {world} ranks, one device each; a mesh takes "
                         "them all")
    axes = tuple(axes)
    shape = (n,) + (1,) * (len(axes) - 1) if shape is None \
        else tuple(int(s) for s in shape)
    if len(shape) != len(axes) or math.prod(shape) != n:
        raise ValueError(f"make_mesh: shape {shape} does not lay out {n} "
                         f"ranks on the axes {axes}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


class RowSplit(NamedTuple):
    """A leading axis cut into ``parts`` ceil-divided blocks (the last ones
    shorter or empty), of which this rank owns block ``index``."""
    parts: int
    index: int

    def slice(self, n: int) -> slice:
        per = -(-int(n) // self.parts)
        lo = min(self.index * per, int(n))
        return slice(lo, min(lo + per, int(n)))


def _flat_index(mesh) -> int:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not part of the mesh")
    return int(np.ravel_multi_index(tuple(coord), tuple(mesh.shape)))


def chains_sharding(mesh) -> RowSplit:
    """A leading chain axis split over the first ("chains") mesh axis."""
    return RowSplit(int(mesh.shape[0]), int(mesh.get_coordinate()[0]))


def flat_sharding(mesh) -> RowSplit:
    """A flattened (chains x draws) axis split over the full mesh, in the
    mesh's row-major rank order."""
    return RowSplit(int(mesh.size()), _flat_index(mesh))


def replicated(mesh) -> RowSplit:
    """The whole axis on every rank."""
    return RowSplit(1, 0)


def pad_to_multiple(x, mult: int, axis: int = 0):
    """Pad the axis length up to a multiple of ``mult`` by repeating its
    last entry (a numpy array or a tensor); returns (padded,
    original_len)."""
    n = x.shape[axis]
    pad = (-n) % int(mult)
    if pad == 0:
        return x, n
    if isinstance(x, torch.Tensor):
        reps = [1] * x.dim()
        reps[axis] = pad
        return torch.cat([x, x.narrow(axis, n - 1, 1).repeat(*reps)],
                         dim=axis), n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, mode="edge"), n


class MeshRun:
    """A rank's part of a run on ``mesh``: its blocks of rows and the
    collectives that put the whole output together on every rank.

    The mesh must hold every rank of the default process group in rank
    order (as ``make_mesh`` lays it out) and live on the run's device type.
    Collectives run with the process group's backend: NCCL on the tensors'
    CUDA device; gloo on host memory, so that a CUDA tensor goes through the
    host explicitly (two ranks on one card, where NCCL refuses to run,
    take gloo).  A failing collective raises."""

    def __init__(self, mesh, device: torch.device):
        if mesh.device_type != device.type:
            raise ValueError(f"the mesh lives on {mesh.device_type} devices, "
                             f"the run on {device}")
        order = mesh.mesh.flatten().tolist()
        if order != list(range(dist.get_world_size())):
            raise ValueError("the mesh must hold every rank of the process "
                             "group in rank order (make_mesh)")
        self.mesh, self.device = mesh, device
        self.chains = chains_sharding(mesh)
        self.flat = flat_sharding(mesh)
        self.chains_group = mesh.get_group(0)
        self.backend = dist.get_backend()
        self.comm_device = torch.device("cpu") if self.backend == "gloo" \
            else device

    def _to_comm(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        return x.to(self.comm_device).contiguous()

    def gather(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """Every rank's ``x`` of ``group`` (default: all ranks) concatenated
        along dim 0 in rank order; the ranks' row counts may differ, their
        other dimensions and dtype may not.  On ``x``'s device."""
        k = dist.get_world_size(group)
        y = self._to_comm(x)
        n = torch.tensor([y.shape[0]], dtype=torch.int64,
                         device=self.comm_device)
        ns = [torch.empty_like(n) for _ in range(k)]
        dist.all_gather(ns, n, group=group)
        ns = [int(v) for v in ns]
        most = max(ns)
        if most == 0:
            return x
        y = pad_to_multiple(y, most)[0] if y.shape[0] \
            else y.new_zeros((most,) + tuple(y.shape[1:]))
        parts = [torch.empty_like(y) for _ in range(k)]
        dist.all_gather(parts, y, group=group)
        out = torch.cat([p[:c] for p, c in zip(parts, ns)])
        return out.to(device=x.device, dtype=x.dtype)

    def gather_chains(self, res: dict) -> dict:
        """Phase 1's results, a dict of tensors with the chain block as
        leading axis (or None), gathered over the "chains" axis."""
        return {k: None if v is None else self.gather(v, self.chains_group)
                for k, v in res.items()}

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` summed ("sum") or maximised ("max") over all ranks."""
        y = self._to_comm(x)
        dist.all_reduce(y, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op])
        return y.to(device=x.device, dtype=x.dtype)
