"""Process groups and the ``(scenario, samples)`` device mesh over ``torch.distributed``.

Counterpart of ``mppi_playground_tpu/parallel/mesh.py``.  Each rank of a
process group drives one device; a :class:`~torch.distributed.device_mesh.DeviceMesh`
names two axes over the ranks:

* ``scenario`` — independent control problems, data parallel: each rank of
  the axis holds and solves its share of a fleet
  (``parallel/sharded.make_batched_fused_solver``);
* ``samples`` — the K rollouts of one solve: each rank rolls out a shard of
  them, and the shards' costs and block partials are gathered over the
  axis's process group (``parallel/sharded.make_sharded_fused_solver``).

The JAX package's ``NamedSharding`` s are DTensor placements here
(:func:`sample_sharding`, :func:`replicated`).
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from mppi_playground_tpu_torch.utils.device import resolve_device

SCENARIO_AXIS = "scenario"
SAMPLE_AXIS = "samples"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    single_host: bool = False,
    device=None,
    backend: Optional[str] = None,
) -> None:
    """Join this process to the default process group (``init_process_group``).

    Args:
        coordinator_address: ``"host:port"`` of rank 0 (``tcp://`` is
            added), or an init URL (``tcp://...``, ``file://...``); ``None``
            reads torchrun's environment (``env://``: ``MASTER_ADDR``,
            ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
        num_processes, process_id: the world size and this process's rank
            (from the environment where ``None``).
        single_host: an explicit no-op, for scripts that run the same code
            on one machine and on many.
        device: the device this rank drives; ``None`` means ``cuda``.  A
            CUDA device becomes the process's current device
            (``torch.cuda.set_device``), which :func:`mesh_device` returns:
            ``"cuda:1"`` that card, and ``None`` or ``"cuda"`` under torchrun
            the card of ``LOCAL_RANK`` (else the current one stays).
        backend: ``None`` picks ``"cpu:gloo,cuda:nccl"`` for a CUDA device
            (NCCL for CUDA tensors, gloo for CPU tensors, which an
            asynchronous directory checkpoint needs) and gloo for the CPU.
            Gloo on a CUDA device lets several ranks share one card, its
            collectives going through host memory (NCCL refuses two ranks on
            one GPU).

    A call once the group exists leaves it as it is; every other error (an
    unreachable address, a missing environment variable) propagates.
    """
    if single_host:
        return
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        index = dev.index
        if index is None and "LOCAL_RANK" in os.environ:
            index = int(os.environ["LOCAL_RANK"])
        if index is not None:
            torch.cuda.set_device(index)
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if dev.type == "cuda" else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(backend, init_method=init_method, **kwargs)


def device_of_ranks(device, world: int) -> torch.device:
    """The device type of ``world`` ranks, one device each: ``None`` means ``cuda``, which
    raises unless the host has ``world`` cards (NCCL takes one card a rank)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < world:
        raise ValueError(f"{world} ranks on cuda need {world} cards, "
                         f"this host has {torch.cuda.device_count()}")
    return dev


def _rank_main(rank: int, fn: Callable, world: int, init_file: str, out_dir: str, device: str,
               args: tuple) -> None:
    """One spawned rank of :func:`run_on_ranks`: join the group, run ``fn``, save its result."""
    if device == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    else:
        device = f"cuda:{rank}"
    initialize_distributed(f"file://{init_file}", world, rank, device=device)
    try:
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_on_ranks(fn: Callable, world: int, args: tuple = (), device=None) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks of one process group.

    Each rank is a process of ``torch.multiprocessing.spawn`` that joins the
    default group through a ``file://`` rendezvous in a temporary directory
    with :func:`initialize_distributed`:
    ``device="cpu"`` makes a gloo group, each rank on one intra-op thread;
    ``"cuda"`` (``None``) the ``cpu:gloo,cuda:nccl`` group, rank r on card r,
    which needs ``world`` cards.  ``fn`` is a module-level function (the
    ranks import it) and returns what :func:`torch.save` can write.

    Returns each rank's return value, in rank order.  A rank that raises
    makes this call raise (``torch.multiprocessing.ProcessRaisedException``,
    with the rank's traceback), the other ranks ended.
    """
    import tempfile

    import torch.multiprocessing as mp

    dev = device_of_ranks(device, world)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(fn, world, os.path.join(tmp, "init"), tmp, dev.type, args),
                 nprocs=world, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def cuda_backend(group=None, backend: Optional[str] = None) -> Optional[str]:
    """The backend that serves CUDA tensors on ``group`` (the default group where ``None``).

    Read from the group's backend string (or ``backend``, where given): a
    plain one (``"nccl"``, ``"gloo"``) serves every device type, and a mixed
    one names a backend a device type (``"cpu:gloo,cuda:nccl"`` -> ``"nccl"``).
    ``None`` where no backend serves CUDA tensors (``"cpu:gloo"``).
    """
    spec = str(dist.get_backend(group) if backend is None else backend).lower()
    if ":" not in spec:
        return spec
    for entry in spec.split(","):
        device_type, _, name = entry.strip().partition(":")
        if device_type == "cuda":
            return name
    return None


def make_mesh(
    mesh_shape: Optional[Tuple[int, int]] = None,
    axis_names: Sequence[str] = (SCENARIO_AXIS, SAMPLE_AXIS),
    devices: Optional[Sequence[int]] = None,
    device_type: Optional[str] = None,
):
    """A 2-D ``(scenario, samples)`` mesh over the ranks of the default process group.

    ``devices`` are the ranks the mesh takes, in mesh order (all of them by
    default, one device each); the default shape puts them all on the sample
    axis, ``(1, n)``.  ``device_type`` is the ranks' devices: ``None`` means
    ``cuda`` where NCCL serves the group's CUDA tensors (:func:`cuda_backend`)
    and ``cpu`` otherwise (a gloo group whose
    ranks share a card passes ``"cuda"``).  Every rank builds the same mesh.
    """
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    n = len(ranks)
    if mesh_shape is None:
        mesh_shape = (1, n)
    if math.prod(mesh_shape) != n:
        raise ValueError(f"mesh_shape {tuple(mesh_shape)} does not match {n} devices")
    if device_type is None:
        device_type = "cuda" if cuda_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(tuple(mesh_shape)),
                      mesh_dim_names=tuple(axis_names))


def mesh_device(mesh) -> torch.device:
    """The device this rank drives on ``mesh``: its current CUDA device, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return resolve_device(mesh.device_type)


def axis_of(mesh, axis: str) -> Tuple[object, int, int]:
    """``(process group, this rank's index, size)`` of the mesh axis named ``axis``."""
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.get_group(dim), mesh.get_local_rank(dim), mesh.size(dim)


def sample_sharding(mesh, ndim: int, axis: str = SAMPLE_AXIS) -> tuple:
    """The DTensor placements that split the leading (sample) axis of an ``ndim`` tensor.

    ``Shard(0)`` on the mesh dimension ``axis``, ``Replicate()`` on the
    others: the JAX package's ``NamedSharding(mesh, P(axis, None, ...))``.
    """
    from torch.distributed.tensor import Replicate, Shard

    if ndim < 1:
        raise ValueError(f"a sample-sharded tensor has a leading axis, got ndim={ndim}")
    dim = mesh.mesh_dim_names.index(axis)
    return tuple(Shard(0) if d == dim else Replicate() for d in range(mesh.ndim))


def replicated(mesh) -> tuple:
    """The DTensor placements of a tensor every rank holds whole: ``Replicate()`` on each axis."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in range(mesh.ndim))
