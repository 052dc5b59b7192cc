"""Multi-process bootstrap: ``torch.distributed`` and a global (chains x
draws) mesh.

Counterpart of ``bssm_tpu/parallel/distributed.py``.  One process a GPU,
on one host or several; chains and IS-correction draws are independent, so
the only traffic between ranks is the gather of the output and the
weighted moments' sums after the run.

Typical launch, one process a GPU (``torchrun`` sets the environment):

    torchrun --nproc-per-node 8 my_run.py

    from bssm_tpu_torch.parallel.distributed import initialize, global_mesh
    initialize()                       # False, nothing to do, in one process
    mesh = global_mesh(("chains", "draws"))
    out = run_mcmc(model, ..., n_chains=8192, mesh=mesh)
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, "") or default)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Start ``torch.distributed`` when running multi-process.

    The arguments default from ``MASTER_ADDR`` / ``MASTER_PORT`` (the
    coordinator, ``host:port``), ``WORLD_SIZE`` and ``RANK``, as
    ``torchrun`` sets them.  The backend defaults to NCCL where CUDA is
    available, else gloo; with CUDA the rank's device is set from
    ``LOCAL_RANK``.  Returns True when a multi-process group was started
    (or one is running already), False for a single process (nothing to
    do)."""
    addr = coordinator_address
    if addr is None and os.environ.get("MASTER_ADDR"):
        addr = f"{os.environ['MASTER_ADDR']}:" \
               f"{os.environ.get('MASTER_PORT', '29500')}"
    nproc = int(num_processes) if num_processes is not None \
        else _env_int("WORLD_SIZE", 0)
    pid = int(process_id) if process_id is not None \
        else _env_int("RANK", -1)
    if coordinator_address is not None and nproc in (0, 1):
        # an explicit coordinator with no process count would silently run
        # every process standalone (duplicated chains, clashing checkpoints)
        raise ValueError(
            "initialize(coordinator_address=...) needs num_processes (and "
            "process_id) or the WORLD_SIZE / RANK environment variables")
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if not addr or nproc in (0, 1):
        return False
    if pid < 0:
        raise ValueError("initialize: a multi-process run needs process_id "
                         "or RANK")
    cuda = torch.cuda.is_available()
    if cuda and os.environ.get("LOCAL_RANK"):
        torch.cuda.set_device(_env_int("LOCAL_RANK", 0))
    dist.init_process_group(backend or ("nccl" if cuda else "gloo"),
                            init_method=f"tcp://{addr}", world_size=nproc,
                            rank=pid)
    return True


def global_mesh(axes: Sequence[str] = ("chains", "draws"),
                shape: Optional[Sequence[int]] = None, device=None):
    """A mesh over every rank of every host.  With no ``shape``, all ranks
    go on the first axis.  Prefer putting the host boundary on the "chains"
    axis: chains never communicate while they run."""
    from .mesh import make_mesh
    return make_mesh(None, axes=axes, shape=shape, device=device)


def local_chain_slice(n_chains: int) -> slice:
    """The [start, stop) block of a global chain axis owned by this process
    (for data loading and checkpoint writes): ceil-divided blocks in rank
    order."""
    p, k = (dist.get_rank(), dist.get_world_size()) \
        if dist.is_initialized() else (0, 1)
    per = -(-n_chains // k)
    return slice(p * per, min((p + 1) * per, n_chains))
