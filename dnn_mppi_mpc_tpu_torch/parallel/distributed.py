"""Process-group initialization on ``torch.distributed`` — counterpart of
``dnn_mppi_mpc_tpu/parallel/distributed.py``.

The JAX package builds meshes over every chip of the job
(``global_sample_mesh``, ``host_scenario_mesh``); here one process drives
one card and the ranks of the default process group take the place of a
mesh axis: the sample-sharded tick and the sharded fleet of
``parallel/sharding.py`` split their work over the ranks of the group they
are given (the default group unless the caller passes another). A second
grouping (scenarios across hosts, samples within) is a ``dist.new_group``
of the caller's choosing.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..solvers.mppi import resolve_device


def initialize_distributed(device="cuda") -> tuple[int, int]:
    """Join the default process group and return ``(rank, world_size)``.

    With ``WORLD_SIZE`` in the environment (``torchrun`` and the like) the
    group comes from ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``),
    and on the card each rank takes card ``LOCAL_RANK``. Otherwise it is a
    single-process group on an in-memory ``dist.HashStore``, which needs no
    port and no network. The backend is NCCL for ``device="cuda"`` (the
    default) and gloo for the CPU. A group that already exists is kept."""
    if not dist.is_initialized():
        device = resolve_device(device)
        backend = "nccl" if device.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            if device.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return dist.get_rank(), dist.get_world_size()


__all__ = ["initialize_distributed"]
