"""The (data, sample) mesh over the ranks of ``torch.distributed``.

Counterpart of ``gp_dla_detection_tpu/parallel/mesh.py``.  The JAX
package drives every local device from one process and lets XLA insert
the collectives; PyTorch's idiom is one process per card
(``torchrun --nproc-per-node N``), so here a mesh is a view of the
default process group:

  - 'data'   axis: spectra, split in per-rank slices of each super-batch
  - 'sample' axis: the QMC samples, split in contiguous z-sorted blocks

Rank r sits at (data, sample) = divmod(r, n_sample), the row-major
layout of the JAX mesh's device grid.  The drivers bring each batch's
results to the host and gather them here, so every rank ends with the
whole catalogue (replicated by construction, as ``fetch_global`` does
in the JAX package) and one code path serves NCCL between cards and
gloo on the CPU or between ranks that share a card.

Uninitialized, ``make_mesh()`` is a one-rank mesh and every collective
here is the identity: the drivers then behave exactly as on one device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "DATA_AXIS",
    "SAMPLE_AXIS",
    "Mesh",
    "all_reduce_sum",
    "barrier",
    "broadcast_object",
    "fetch_global",
    "initialize_distributed",
    "is_coordinator",
    "make_mesh",
    "rank_device",
    "shutdown",
]

DATA_AXIS = "data"
SAMPLE_AXIS = "sample"


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, sample) mesh of the default process
    group.  ``groups`` maps an axis to the process group of the ranks
    that differ from this one only along it, or None where there is
    nothing to exchange (an axis of size 1 in a larger world, or no
    process group).  ``device`` is the rank's card, or None for the
    port's default (``runtime.default_device``)."""

    world: int
    rank: int
    local_rank: int
    n_data: int
    n_sample: int
    groups: dict
    device: torch.device | None = None
    backend: str | None = None

    axis_names = (DATA_AXIS, SAMPLE_AXIS)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_data, SAMPLE_AXIS: self.n_sample}

    @property
    def size(self) -> int:
        return self.world

    @property
    def data_index(self) -> int:
        return self.rank // self.n_sample

    @property
    def sample_index(self) -> int:
        return self.rank % self.n_sample

    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0

    @property
    def comm_device(self) -> torch.device:
        """Where collective buffers live: the card under NCCL, else the
        host (gloo gathers host tensors)."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


def _card(backend: str | None, world: int, local_rank: int) -> torch.device | None:
    if backend == "nccl":
        return torch.device("cuda", local_rank)
    if world > 1 and torch.cuda.is_available():
        # ranks may share a card (gloo): the LOCAL_RANK-th, wrapped
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return None


def make_mesh(num_devices: int | None = None, sample_parallelism: int = 1) -> Mesh:
    """The (data, sample) mesh over the initialized process group's
    ranks, ``sample_parallelism`` of them along the sample axis; a
    one-rank mesh when no process group is initialized.

    Unlike the JAX package's ``make_mesh``, which takes every local
    device of one process, a rank here is one process with one card:
    ``num_devices``, when given, must equal the world size.  Every rank
    must call this, in the same order: it creates the axis groups."""
    if _initialized():
        world, rank, backend = dist.get_world_size(), dist.get_rank(), dist.get_backend()
    else:
        world, rank, backend = 1, 0, None
    if num_devices is not None and num_devices != world:
        raise ValueError(
            f"num_devices={num_devices}, but the process group has {world} "
            "rank(s): the port runs one process per card, so the mesh spans "
            "the whole world (start N ranks with torchrun --nproc-per-node N)"
        )
    if sample_parallelism < 1 or world % sample_parallelism:
        raise ValueError(
            f"{world} devices not divisible by sample_parallelism={sample_parallelism}"
        )
    n_sample = sample_parallelism
    n_data = world // n_sample
    groups = {}
    for axis, size, members in (
        (DATA_AXIS, n_data, lambda s: [d * n_sample + s for d in range(n_data)]),
        (SAMPLE_AXIS, n_sample, lambda d: [d * n_sample + s for s in range(n_sample)]),
    ):
        if backend is None or (size == 1 < world):
            groups[axis] = None
        elif size == world:
            # a one-rank world keeps its group: its collectives still run
            groups[axis] = dist.group.WORLD
        else:
            # new_group is collective: every rank creates every group
            mine = rank % n_sample if axis == DATA_AXIS else rank // n_sample
            for i in range(world // size):
                group = dist.new_group(members(i))
                if i == mine:
                    groups[axis] = group
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    return Mesh(
        world, rank, local_rank, n_data, n_sample, groups,
        device=_card(backend, world, local_rank), backend=backend,
    )


def rank_device(device, mesh: Mesh | None):
    """Where a rank's tensors live: ``device`` when named, else the
    mesh's card for this rank (None, the port's default device, without
    a mesh or a card of its own)."""
    return device if device is not None or mesh is None else mesh.device


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Join the default process group; a no-op for one process, as in
    the JAX package.

    ``coordinator_address`` ("host:port" or a URL such as
    "tcp://localhost:29500"); None reads torchrun's environment
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).  ``backend`` None
    picks NCCL when every local rank has a card of its own and gloo
    otherwise (several ranks on one card, or no card).  A process that
    already joined one keeps it."""
    if _initialized():
        return
    if not ((num_processes is not None and num_processes > 1) or coordinator_address):
        return
    rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes or 1))
    if backend is None:
        own_cards = torch.cuda.is_available() and torch.cuda.device_count() >= local_world
        backend = "nccl" if own_cards else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes, rank=process_id,
    )


def fetch_global(x, mesh: Mesh | None = None, axis: str = DATA_AXIS, dim: int = 0) -> np.ndarray:
    """``x`` (a tensor or an array) as a host ndarray, all-gathered along
    ``axis`` of ``mesh`` and concatenated along ``dim`` in rank order.
    Every rank of the axis passes an ``x`` of the same shape and dtype
    and gets the same result; on an axis with no group this is a copy to
    the host, or no copy for a host tensor (the pinned buffers the
    drivers' results land in) or array."""
    if mesh is None or mesh.groups[axis] is None:
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    t = x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    # a pinned host tensor goes to the card without a wait: the gather
    # runs after the copy on the same stream
    t = t.to(mesh.comm_device, non_blocking=t.is_pinned()).contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, t, group=mesh.groups[axis])
    return np.concatenate([p.cpu().numpy() for p in parts], axis=dim)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh | None, axis: str = DATA_AXIS) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` of ``mesh``, on ``x``'s device."""
    if mesh is None or mesh.groups[axis] is None:
        return x
    t = x.detach().to(mesh.comm_device).clone()
    dist.all_reduce(t, group=mesh.groups[axis])
    return t.to(x.device)


def broadcast_object(obj, mesh: Mesh | None):
    """``obj`` of the coordinator (rank 0), on every rank of the mesh:
    decisions that every rank must take alike (which batches resume)."""
    if mesh is None or mesh.backend is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=mesh.comm_device)
    return box[0]


def barrier(mesh: Mesh | None) -> None:
    """Wait for every rank of the mesh."""
    if mesh is None or mesh.backend is None:
        return
    if mesh.backend == "nccl":
        dist.barrier(device_ids=[mesh.device.index])
    else:
        dist.barrier()


def is_coordinator() -> bool:
    """True on the process that owns checkpoint, manifest and artifact
    writes (rank 0, or the only process)."""
    return not _initialized() or dist.get_rank() == 0


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined)."""
    if _initialized():
        dist.destroy_process_group()
