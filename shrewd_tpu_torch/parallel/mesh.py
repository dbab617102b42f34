"""Device meshes over local devices and ``torch.distributed`` (the port of
``shrewd_tpu/parallel/mesh.py``).

The reference spreads a batch's trials over one ``jax.sharding.Mesh`` with a
``trials`` axis and reduces the tallies with a ``psum``.  Here a ``Mesh`` is
this process's local devices plus, when a ``torch.distributed`` group is
initialised, the world of processes: its ``size`` is local devices × world
size, and the global trial axis is rank-major (process 0's shards first,
then process 1's, each in local-device order), as in the reference's global
mesh.  Every process computes the same global key batch and takes its own
rows (``shard_keys``); the campaign step sums its local shards' tallies and
reduces them across processes with ``all_reduce(SUM)`` (``Mesh.all_reduce``)
— the collective that is also the barrier.

``make_mesh(["cpu"] * 4)`` lists the CPU four times: four shards on one
device, the counterpart of XLA's forced host-platform device count, which is
how the CPU tests reach a 4-device mesh.  A CUDA mesh lists distinct cards.

Multi-process: call ``init_distributed()`` once per process before the
mesh is made (NCCL for the card, gloo for the CPU), or initialise a group
yourself; ``make_mesh`` spans whichever group is initialised.
"""

from __future__ import annotations

import numpy as np
import torch

def _dist():
    """``torch.distributed`` when a process group is initialised, else
    None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist
    return None


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> None:
    """Join a multi-process campaign (a no-op for one process, as the
    reference's is): ``torch.distributed.init_process_group`` over
    ``tcp://{coordinator_address}`` (``host:port``), NCCL for the card and
    gloo for the CPU unless ``backend`` names one."""
    if num_processes is None or num_processes <= 1:
        return
    import torch.distributed as dist

    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))


def shutdown_distributed() -> None:
    """Tear the process group down (it is process-wide: a later phase or
    test must not inherit it)."""
    dist = _dist()
    if dist is not None:
        dist.destroy_process_group()


def _canonical(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def same_device(a, b) -> bool:
    """Whether two device names denote one device (``cuda`` is the current
    card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return a.index == b.index
    return _canonical(a) == _canonical(b)


class Mesh:
    """This process's local devices and the ``torch.distributed`` world
    they belong to.

    ``devices``: the local devices, one shard each; ``world_size`` and
    ``rank`` the process group's (1 and 0 without one); ``size`` the global
    shard count; ``offset`` this process's first shard on the global trial
    axis.  ``reductions`` counts the collectives the campaign steps ran
    over ``backend`` (None without a group)."""

    def __init__(self, devices, backend: str | None = None,
                 world_size: int = 1, rank: int = 0):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.backend = backend
        self.world_size = int(world_size)
        self.rank = int(rank)
        self.local_size = len(self.devices)
        self.size = self.local_size * self.world_size
        self.offset = self.rank * self.local_size
        self.reductions = 0

    def identity(self) -> tuple:
        """What distinguishes this mesh from another in a step key: its
        local devices and its world."""
        return (tuple(str(d) for d in self.devices), self.world_size,
                self.rank, self.backend)

    def __repr__(self) -> str:
        return (f"Mesh(devices={[str(d) for d in self.devices]}, "
                f"world_size={self.world_size}, rank={self.rank}, "
                f"backend={self.backend})")

    def _comm_device(self) -> torch.device:
        return (self.devices[0] if self.backend == "nccl"
                else torch.device("cpu"))

    def all_reduce(self, local: np.ndarray) -> np.ndarray:
        """The sum over every process of an int64 array (this process's
        local sum): ``all_reduce(SUM)`` over the group, or the array itself
        without one."""
        local = np.asarray(local, dtype=np.int64)
        dist = _dist()
        if self.backend is None or dist is None:
            return local.copy()
        buf = torch.as_tensor(local.reshape(-1), dtype=torch.int64,
                              device=self._comm_device())
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
        self.reductions += 1
        return buf.cpu().numpy().reshape(local.shape)

    def all_gather(self, local: np.ndarray) -> np.ndarray:
        """Every process's (local_size, ...) int64 array, stacked in rank
        order → (size, ...): the global shard axis."""
        local = np.asarray(local, dtype=np.int64)
        dist = _dist()
        if self.backend is None or dist is None:
            return local.copy()
        buf = torch.as_tensor(local, dtype=torch.int64,
                              device=self._comm_device()).contiguous()
        out = [torch.empty_like(buf) for _ in range(self.world_size)]
        dist.all_gather(out, buf)
        self.reductions += 1
        return torch.cat(out).cpu().numpy()


def make_mesh(devices=None) -> Mesh:
    """A mesh over the given local devices (default: every visible CUDA
    card; it raises without one), spanning the ``torch.distributed`` group
    when one is initialised.  A CUDA mesh lists distinct cards; the CPU may
    be listed more than once."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() spans the CUDA cards and none is available; "
                "pass device='cpu' (or devices=['cpu', ...]) to run on the "
                "CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [_canonical(d) for d in devices]
    cuda = [d for d in devs if d.type == "cuda"]
    if len(set(cuda)) != len(cuda):
        raise ValueError(f"a CUDA mesh lists distinct cards, got "
                         f"{[str(d) for d in devs]}")
    dist = _dist()
    if dist is None:
        return Mesh(devs)
    return Mesh(devs, backend=str(dist.get_backend()),
                world_size=dist.get_world_size(), rank=dist.get_rank())


def round_up_to_mesh(n: int, mesh_size: int) -> int:
    """Smallest multiple of ``mesh_size`` that is >= ``n``: the
    orchestrator rounds its plan's batch size up through this (with a
    warning) instead of failing at the first ``shard_keys``.  The raise in
    ``shard_keys`` stays: a direct call with an indivisible batch is a
    caller bug."""
    if mesh_size <= 0:
        raise ValueError(f"mesh size must be positive, got {mesh_size}")
    return -(-int(n) // int(mesh_size)) * int(mesh_size)


def shard_keys(mesh: Mesh, keys: torch.Tensor) -> list[torch.Tensor]:
    """This process's shards of a global (B, 2) key batch, each on its
    device: global shard ``mesh.offset + j`` holds rows ``[s*b, (s+1)*b)``
    of the batch (b = B / mesh.size)."""
    n = int(keys.shape[0])
    if n % mesh.size:
        raise ValueError(
            f"batch size {n} not divisible by mesh size {mesh.size}")
    b = n // mesh.size
    return [keys[(mesh.offset + j) * b:(mesh.offset + j + 1) * b].to(d)
            for j, d in enumerate(mesh.devices)]


def shard_batch_stack(mesh: Mesh, keys_list) -> list[list[torch.Tensor]]:
    """The per-shard view of S batches: ``out[j][i]`` is local shard j of
    batch i (the interval steps' input).  Single-process only: the
    interval and until-CI engines gate on a world of one, as the
    reference's do."""
    if mesh.world_size != 1:
        raise ValueError("shard_batch_stack is single-process only")
    shards = [shard_keys(mesh, k) for k in keys_list]
    return [[s[j] for s in shards] for j in range(mesh.local_size)]


def replicated(mesh: Mesh, x) -> list[torch.Tensor]:
    """A copy of ``x`` on each local device."""
    t = torch.as_tensor(x)
    return [t.to(d) for d in mesh.devices]
