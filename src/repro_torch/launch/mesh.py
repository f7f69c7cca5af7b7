"""Device meshes over ``torch.distributed``.

Every function here builds a ``DeviceMesh`` (``init_device_mesh``) over the
ranks of the default process group, with dim names ``("data", "model")`` or
``("pod", "data", "model")``, and refuses a mesh whose size differs from
the world's.  Nothing runs at import time.

Backends: NCCL when every rank has a card of its own; gloo when the tensors
are on the CPU, or when ranks share a card (NCCL refuses two ranks on one
device).  gloo's collectives on CUDA tensors are staged through the host by
the serving trunk (:mod:`repro_torch.serve.tensor_parallel`).

A 1 x 1 mesh needs no launcher: without a process group,
:func:`make_serving_mesh` starts a world of one on a free localhost port.
Larger meshes need their ranks started first (``python -m
repro_torch.launch.serve --mesh-data D --mesh-model M`` starts them, and
:func:`init_from_env` joins the world ``python -m torch.distributed.run``
describes).
"""
from __future__ import annotations

import logging
import os
import socket
from datetime import timedelta

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

logger = logging.getLogger(__name__)

SERVING_AXES = ("data", "model")
TIMEOUT = timedelta(minutes=10)


def free_port() -> int:
    """An unused TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def backend_for(device, world: int) -> str:
    """"nccl" when each of ``world`` ranks can have a card of its own,
    else "gloo" (CPU tensors, or ranks sharing cards)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def init_world(rank: int, world: int, port: int, device) -> str:
    """Join a ``world``-rank process group at ``tcp://localhost:port`` with
    :func:`backend_for`'s backend (a CUDA rank first selects card ``rank %
    cards``); returns the backend."""
    dev = resolve_device(device)
    backend = backend_for(dev, world)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank, timeout=TIMEOUT)
    return backend


def init_from_env(device) -> int:
    """Join the process group a launcher describes in the environment
    (``torchrun``'s ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` / ``MASTER_PORT``) with :func:`backend_for`'s backend,
    a CUDA rank first selecting card ``LOCAL_RANK % cards``; returns the
    world size.  A running group is kept; without one and without a world
    of more than one rank in the environment nothing is started (1)."""
    if dist.is_initialized():
        return dist.get_world_size()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 1
    dev = resolve_device(device)
    rank = int(os.environ["RANK"])
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend_for(dev, world), init_method="env://",
                            world_size=world, rank=rank, timeout=TIMEOUT)
    return world


def _device_mesh(shape: tuple, names: tuple, device):
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    need = 1
    for n in shape:
        need *= n
    if not dist.is_initialized():
        if need != 1:
            raise ValueError(
                f"mesh {dict(zip(names, shape))} needs {need} ranks but no "
                f"process group is running: start the ranks first (python "
                f"-m repro_torch.launch.serve --mesh-data D --mesh-model M "
                f"starts them) or call torch.distributed."
                f"init_process_group")
        init_world(0, 1, free_port(), dev)
    world = dist.get_world_size()
    if need != world:
        raise ValueError(
            f"mesh {dict(zip(names, shape))} needs {need} ranks but the "
            f"process group holds {world}: make the axes' product equal "
            f"the world size")
    backend = dist.get_backend()
    if backend == "nccl" and (dev.type != "cuda"
                              or torch.cuda.device_count() < world):
        raise ValueError(
            f"an NCCL group of {world} ranks needs a card each; "
            f"{torch.cuda.device_count() if dev.type == 'cuda' else 0} are "
            f"visible — share cards over gloo instead")
    mesh = init_device_mesh(dev.type, shape, mesh_dim_names=names)
    logger.info("mesh %s over %d rank(s), backend %s on %s",
                dict(zip(names, shape)), world, backend, dev.type)
    return mesh


def make_mesh(data: int, model: int, pods: int = 1, *, device="cuda"):
    """An arbitrary mesh for elastic configurations and tests."""
    if pods > 1:
        return _device_mesh((pods, data, model), ("pod",) + SERVING_AXES,
                            device)
    return _device_mesh((data, model), SERVING_AXES, device)


def make_host_mesh(*, device="cuda"):
    """Every rank of the process group (one without a group) as a
    (1, world) mesh."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return _device_mesh((1, world), SERVING_AXES, device)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) with a "pod"
    axis; refused unless the world holds that many ranks."""
    if multi_pod:
        return _device_mesh((2, 16, 16), ("pod",) + SERVING_AXES, device)
    return _device_mesh((16, 16), SERVING_AXES, device)


def make_serving_mesh(data: int, model: int, *, device="cuda"):
    """A validated (data, model) mesh for the serving Engine: positive
    axes whose product is the world size (1 x 1 starts a world of one
    when no group runs), with an actionable message otherwise."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be positive; got data={data}, "
                         f"model={model}")
    return _device_mesh((data, model), SERVING_AXES, device)
