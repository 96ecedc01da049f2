"""Multi-process bring-up: one process a rank, joined by ``torch.distributed``.

Port of ``mpc_rs_tpu/parallel/distributed.py``. The JAX package joins
processes with ``jax.distributed.initialize`` into one global device mesh;
here each rank is a process with one device, ``cuda:LOCAL_RANK``, and the
collectives run over NCCL between cards or over gloo (CPU tensors, and two
ranks that share one card: gloo's CUDA tensors take ``all_reduce`` and
``broadcast``, all the rollout merge needs). The ``rollouts`` and
``scenario`` axes are laid out by ``parallel/mesh.py``.

A process that is not started as a rank (no ``RANK``/``WORLD_SIZE`` in its
environment) calls nothing here, and every app runs as on one device.
Under ``python -m torch.distributed.run`` the environment names the rank,
the world and the rendezvous, and ``init_distributed()`` needs no argument.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from mpc_rs_tpu_torch.parallel.mesh import Mesh, make_mesh, world


def launched() -> bool:
    """Whether this process was started as a rank (``RANK`` and
    ``WORLD_SIZE`` in its environment, as ``torch.distributed.run`` sets)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def rank_device(device: str | torch.device | None = None, local_rank: int | None = None) -> torch.device:
    """This rank's device: the CPU when asked for, else ``cuda:LOCAL_RANK``,
    wrapped onto the host's cards when more ranks than cards share them (two
    gloo ranks on one card both take ``cuda:0``)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", 0)) if local_rank is None else local_rank
    cards = torch.cuda.device_count()
    return torch.device("cuda", local % cards if cards else local)


def init_distributed(init_method: str | None = None, world_size: int | None = None, rank: int | None = None,
                     backend: str | None = None, timeout_s: float = 120.0,
                     device: str | torch.device | None = None) -> torch.device:
    """Join the default process group; returns this rank's device
    (``rank_device``). A no-op, but for the device, when a group exists.

    ``rank``/``world_size`` default to ``RANK``/``WORLD_SIZE`` of the
    environment and ``init_method`` to ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``, as ``torch.distributed.run`` sets them); tests pass
    ``file://`` stores. ``backend`` None is NCCL when the rank's device is
    CUDA, gloo on the CPU. NCCL takes one card a rank: asking for it with
    more ranks on this host (``LOCAL_WORLD_SIZE``, else the world) than
    ``torch.cuda.device_count()`` raises, naming gloo, before any group is
    made. ``timeout_s`` bounds every collective, so a rank that dies fails
    the others instead of hanging them."""
    dev = rank_device(device)
    if dist.is_initialized():
        return dev
    if rank is None or world_size is None:
        if not launched():
            raise ValueError("init_distributed needs rank and world_size, or RANK and WORLD_SIZE in the "
                             "environment (python -m torch.distributed.run sets them)")
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        cards = torch.cuda.device_count()
        if dev.type != "cuda":
            raise ValueError("NCCL runs between CUDA devices; a CPU rank takes backend='gloo'")
        if local_world > cards:
            raise ValueError(f"NCCL takes one card a rank: {local_world} ranks on this host, {cards} card(s). "
                             "Ranks that share a card take backend='gloo' (the fleet CLI's --dist-backend gloo)")
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def global_rollout_mesh(scenario_axis: int = 1) -> Mesh:
    """Every rank on (scenario, rollouts); rollouts is the fastest axis."""
    _, n = world()
    if n % scenario_axis:
        raise ValueError(f"{n} ranks not divisible by scenario={scenario_axis}")
    return make_mesh({"scenario": scenario_axis, "rollouts": n // scenario_axis})
