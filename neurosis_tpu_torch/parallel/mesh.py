"""The process group and the (data, fsdp[, context]) device mesh (port of
neurosis_tpu/parallel/mesh.py).

One process drives one card. ``init_distributed`` reads the launcher's
environment (torchrun, then SLURM, then the JAX package's ``NEUROSIS_*``
variables, ``tools/launch_pod.py``) and starts the process group: NCCL on
CUDA, gloo only when the caller asks for the CPU (the tests). A node is the
set of processes on one host, JAX's process: its ranks are contiguous.

``make_mesh`` lays the ranks out as a (data, fsdp) ``DeviceMesh``, or,
with ``context`` > 1, a (data, fsdp, context) one with the context axis
last, as JAX's: the parameters shard over ``fsdp`` (``parallel/fsdp.py``)
and replicate over ``data`` (and ``context``). ``shard_batch`` keeps JAX's
placement of a batch: its rows split over the data axis only, each node's
share over the node's part of the axis, and a leaf replicated where JAX
replicates it. The ranks of one data index (its fsdp and context ranks)
hold the same rows, as the chips of a JAX data group do; the context ranks
of one (data, fsdp) index split each self-attention's sequence over their
ring (``ops/ring_attention.py``) and compute the same gradients.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Mapping, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from .rows import Rows

logger = logging.getLogger(__name__)

@dataclasses.dataclass(frozen=True)
class DistEnv:
    """Where this process sits, as the launcher's environment says."""

    rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    local_world_size: int = 1
    master_addr: str = "localhost"
    master_port: int = 29500
    source: str = "none"

    @property
    def node(self) -> int:
        return self.rank // self.local_world_size

    @property
    def nodes(self) -> int:
        return max(self.world_size // self.local_world_size, 1)


def _slurm_first_host(nodelist: str) -> str:
    """The first host of a SLURM node list (``gpu[01-04],gpu07`` → ``gpu01``)."""
    first = nodelist.split(",")[0]
    if "[" not in first:
        return first
    stem, rest = first.split("[", 1)
    return stem + rest.split("-")[0].split("]")[0]


def dist_env(env: Optional[Mapping[str, str]] = None) -> DistEnv:
    """The launcher's environment: torchrun's ``RANK``/``WORLD_SIZE``/
    ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``,
    else SLURM's (``SLURM_PROCID``/``SLURM_NTASKS``/``SLURM_LOCALID``/
    ``SLURM_NTASKS_PER_NODE``, the first host of the node list as the master),
    else ``NEUROSIS_COORDINATOR`` (host:port)/``NEUROSIS_NUM_PROCESSES``/
    ``NEUROSIS_PROCESS_ID`` (with ``NEUROSIS_LOCAL_RANK`` and
    ``NEUROSIS_LOCAL_WORLD_SIZE``, default one process a node, as JAX's);
    without any of them, one process."""
    env = os.environ if env is None else env
    if "RANK" in env and "WORLD_SIZE" in env:
        world = int(env["WORLD_SIZE"])
        return DistEnv(int(env["RANK"]), world, int(env.get("LOCAL_RANK", 0)),
                       int(env.get("LOCAL_WORLD_SIZE", world)), env.get("MASTER_ADDR", "localhost"),
                       int(env.get("MASTER_PORT", 29500)), "torchrun")
    if env.get("SLURM_JOB_ID") and "SLURM_PROCID" in env:
        world = int(env.get("SLURM_NTASKS", 1))
        per_node = int(str(env.get("SLURM_NTASKS_PER_NODE", world)).split("(")[0])
        nodelist = env.get("SLURM_STEP_NODELIST", env.get("SLURM_JOB_NODELIST", "localhost"))
        return DistEnv(int(env["SLURM_PROCID"]), world, int(env.get("SLURM_LOCALID", 0)), per_node,
                       env.get("MASTER_ADDR", _slurm_first_host(nodelist)), int(env.get("MASTER_PORT", 29500)),
                       "slurm")
    if env.get("NEUROSIS_COORDINATOR"):
        host, _, port = env["NEUROSIS_COORDINATOR"].rpartition(":")
        return DistEnv(int(env["NEUROSIS_PROCESS_ID"]), int(env["NEUROSIS_NUM_PROCESSES"]),
                       int(env.get("NEUROSIS_LOCAL_RANK", 0)), int(env.get("NEUROSIS_LOCAL_WORLD_SIZE", 1)),
                       host or "localhost", int(port), "neurosis")
    return DistEnv()


@dataclasses.dataclass
class Dist:
    """This process in the started group: its place and its device."""

    env: DistEnv
    device: torch.device

    @property
    def rank(self) -> int:
        return self.env.rank

    @property
    def world_size(self) -> int:
        return self.env.world_size


def init_distributed(device: DeviceLike = None, env: Optional[DistEnv] = None,
                     init_method: Optional[str] = None) -> Dist:
    """Start the process group of ``env`` (default ``dist_env()``) once:
    NCCL on ``cuda:{LOCAL_RANK}`` (``torch.cuda.set_device``), gloo when
    ``device`` is the CPU. One process without a launcher gets a group of
    one (an in-memory store). A failed start raises: a rank never trains
    alone, nor on the CPU because CUDA is missing (``resolve_device``)."""
    import torch.distributed as dist

    env = env or dist_env()
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", env.local_rank)
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        if init_method is None and env.world_size == 1 and env.source == "none":
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        else:
            init_method = init_method or f"tcp://{env.master_addr}:{env.master_port}"
            dist.init_process_group(backend, init_method=init_method, rank=env.rank, world_size=env.world_size,
                                    device_id=dev if dev.type == "cuda" else None)
    if dist.get_world_size() != env.world_size or dist.get_rank() != env.rank:
        raise RuntimeError(f"the process group has rank {dist.get_rank()} of {dist.get_world_size()}, "
                           f"the environment says {env.rank} of {env.world_size}")
    logger.info(f"rank {env.rank} of {env.world_size} ({env.source}, {backend}) on {dev}")
    return Dist(env, dev)


def mesh_shape(n: int, data: Optional[int] = None, fsdp: int = 1, context: int = 1) -> tuple[int, ...]:
    """The mesh of ``n`` ranks as JAX's ``make_mesh`` shapes it: (data,
    fsdp), or (data, fsdp, context) with ``context`` > 1; ``data=None`` takes
    what fsdp and context leave. Raises where JAX's raises, with its
    message."""
    context = int(context or 1)
    if data is None:
        if n % (fsdp * context):
            raise ValueError(f"{n} devices not divisible by fsdp={fsdp} x context={context}")
        data = n // (fsdp * context)
    if data * fsdp * context != n:
        raise ValueError(f"mesh {data}x{fsdp}x{context} != {n} devices")
    return (data, fsdp, context) if context > 1 else (data, fsdp)


@dataclasses.dataclass
class Mesh:
    """The (data, fsdp[, context]) ``DeviceMesh`` and this rank's place in
    it. ``fsdp_mesh`` is the mesh the parameters shard over: the device mesh
    itself without a context axis, else a (data·context, fsdp) one over the
    same ranks (``parallel/fsdp.py``)."""

    device_mesh: Any  # torch.distributed.device_mesh.DeviceMesh
    dist: Dist
    fsdp_mesh: Any = None
    _ring: Any = None

    @property
    def data(self) -> int:
        return self.device_mesh.size(0)

    @property
    def fsdp(self) -> int:
        return self.device_mesh.size(1)

    @property
    def context(self) -> int:
        return self.device_mesh.size(2) if self.device_mesh.ndim == 3 else 1

    @property
    def data_index(self) -> int:
        return self.device_mesh.get_local_rank("data")

    @property
    def context_index(self) -> int:
        return self.device_mesh.get_local_rank("context") if self.context > 1 else 0

    @property
    def context_group(self):
        """The ranks of this rank's (data, fsdp) index, one a slice of the
        sequence; None without a context axis."""
        return self.device_mesh.get_group("context") if self.context > 1 else None

    @property
    def context_ring(self):
        """The ring over ``context_group`` (``ops/ring_attention.P2PRing``),
        made once; None without a context axis."""
        if self._ring is None and self.context > 1:
            from ..ops.ring_attention import P2PRing

            self._ring = P2PRing(self.context_group)
        return self._ring

    @property
    def row_group(self):
        """The ranks that hold other rows of the batch than this one: this
        rank's fsdp and context index, every data index."""
        return self.device_mesh.get_group("data")

    @property
    def is_writer(self) -> bool:
        """Global rank 0 writes the run's logs and checkpoints."""
        return self.dist.rank == 0

    @property
    def is_node_writer(self) -> bool:
        """Local rank 0 of each node writes what JAX's process writes (images)."""
        return self.dist.env.local_rank == 0

    def shard(self, arrays: dict) -> tuple[dict, Optional[Rows]]:
        """This rank's part of a node's batch (``shard_batch``)."""
        return shard_batch(arrays, self.data, self.data_index, self.dist.env.nodes, self.dist.env.node,
                           self.row_group)

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier(device_ids=[self.dist.device.index] if self.dist.device.type == "cuda" else None)


def make_mesh(dist_: Dist, data: Optional[int] = None, fsdp: int = 1, context: int = 1) -> Mesh:
    """The (data, fsdp) mesh over every rank of the started group, or with
    ``context`` > 1 the (data, fsdp, context) one (rank r at data r // (F·C),
    fsdp r // C % F, context r % C), and its parameters' (data·context,
    fsdp) mesh over the same ranks. Every rank calls it (it makes groups)."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    data, fsdp, context = (mesh_shape(dist_.world_size, data, fsdp, context) + (1,))[:3]
    kind = dist_.device.type
    if context == 1:
        device_mesh = init_device_mesh(kind, (data, fsdp), mesh_dim_names=("data", "fsdp"))
        return Mesh(device_mesh, dist_, device_mesh)
    device_mesh = init_device_mesh(kind, (data, fsdp, context), mesh_dim_names=("data", "fsdp", "context"))
    ranks = torch.arange(dist_.world_size).reshape(data, fsdp, context).permute(0, 2, 1).reshape(data * context, fsdp)
    return Mesh(device_mesh, dist_, DeviceMesh(kind, ranks, mesh_dim_names=("replicate", "fsdp")))


def _leading(x) -> Optional[int]:
    return int(np.shape(x)[0]) if np.ndim(x) >= 1 else None


def row_split(batch: Mapping[str, Any], data: int, nodes: int = 1) -> tuple[int, int, dict]:
    """JAX's ``shard_batch`` decision (mesh.py:67-129) on a node's batch:
    (local_data, batch size, {key: True where the leaf's rows split over the
    data axis, False where it is replicated}). ``local_data`` is the node's
    share of the data axis; a leaf splits when its leading dim is the batch
    size (the largest leading dim) and ``local_data`` divides it."""
    local_data = max(data // nodes if nodes > 1 else data, 1)
    leading = [d for d in (_leading(v) for v in batch.values()) if d is not None]
    local_bs = max(leading) if leading else 0
    split = {}
    for k, v in batch.items():
        d = _leading(v)
        split[k] = d is not None and d == local_bs and d >= local_data and d % local_data == 0
        if d is not None and not split[k] and d != local_bs and d >= local_data and d % local_data == 0:
            logger.warning(f"shard_batch: leaf {k!r} with leading dim {d} != batch size {local_bs} replicated "
                           "over the mesh; verify it is identical across nodes")
    return local_data, local_bs, split


def shard_batch(batch: Mapping[str, Any], data: int, data_index: int, nodes: int = 1, node: int = 0,
                group: Any = None) -> tuple[dict, Optional[Rows]]:
    """This rank's part of a node's host batch (numpy arrays): the rows of
    its data index in each leaf that ``row_split`` splits, the whole of
    every other leaf; and the ``Rows`` it holds of the global batch (every
    node's batch, in node order), None when nothing splits and every rank
    holds the whole batch, which is then the one-card step's. A node whose
    batch does not split while other nodes hold other batches raises, where
    JAX warns that the result is wrong."""
    local_data, local_bs, split = row_split(batch, data, nodes)
    if not any(split.values()):
        if nodes > 1:
            raise ValueError(f"a batch of {local_bs} rows does not split over the node's {local_data} data "
                             f"ranks, and {nodes} nodes hold different batches")
        return dict(batch), None
    per = local_bs // local_data
    i = data_index % local_data
    out = {k: (v[i * per:(i + 1) * per] if split[k] else v) for k, v in batch.items()}
    start = node * local_bs + i * per
    return out, Rows(start, start + per, nodes * local_bs, group)
