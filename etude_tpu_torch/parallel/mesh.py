"""Process groups and the (data, model) mesh of multi-GPU training (JAX
counterpart: etude_tpu/parallel/mesh.py).

JAX lays a named mesh over every device of the job and lets XLA insert the
collectives that its sharding annotations imply. The port runs one process
per device (a rank; NCCL takes no two ranks on one card) in a
`torch.distributed` process group, and its training step calls the
collectives itself (parallel/train_step.py). A `Mesh` is one rank's view of
the job: the two axis sizes, its rank, its device and the group of ranks its
gradients are summed over.

Rank r sits at (r // model_parallel, r % model_parallel) of the
[data_parallel, model_parallel] grid, as JAX's
`devices.reshape(data_parallel, model_parallel)` (:41) places devices. The
model axis shards nothing, as in JAX, whose step uses only the data axis:
the ranks of one data position hold the same rows and compute the same
gradients.

Collectives run over NCCL on the card; gloo serves only a caller that asks
for the CPU (the tests). There is no fallback: fewer cards than ranks
raises, and so does a collective that fails or times out.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import math
import os
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device, with_index
from ..utils.logger import logger

# How long a collective may wait for a lost or stalled rank before it raises.
DEFAULT_TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a [data_parallel, model_parallel] grid of ranks.

    `group` is the process group of the ranks that share this rank's model
    position (its data axis), over which gradients are summed; None only in
    a job of one process that formed no group, where nothing is reduced."""

    data_parallel: int
    model_parallel: int
    rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup]

    @property
    def data_index(self) -> int:
        """This rank's position on the data axis: which rows it holds."""
        return self.rank // self.model_parallel


def _group_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """`device` (a bare `cuda` is the current card), or the group's kind;
    without a group, the current card."""
    if device is not None:
        return with_index(device)
    if dist.is_initialized():
        if dist.get_backend() == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")
    return with_index(resolve_device("cuda"))


def make_mesh(
    data_parallel: int = -1,
    model_parallel: int = 1,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> Mesh:
    """The mesh of this rank over the job's ranks (JAX `make_mesh` :21).

    `devices` lists the device of each rank, in rank order (default: every
    rank of the process group, each on its own device; a job without a
    group is one rank on the card). data_parallel == -1 takes every device
    that model_parallel leaves; a grid larger than the devices raises, as in
    JAX. Unlike JAX, which may leave devices out, the grid must cover every
    rank of the job: a rank outside it would have nothing to compute. Every
    rank calls this together when model_parallel > 1 (it forms the data
    axes' groups)."""
    initialized = dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    n = len(devices) if devices is not None else world
    if model_parallel < 1:
        model_parallel = 1
    if data_parallel == -1:
        data_parallel = n // model_parallel
    total = data_parallel * model_parallel
    if total > n:
        raise ValueError(
            f"mesh {data_parallel}x{model_parallel} needs {total} devices, have {n}")
    if total != world:
        raise ValueError(
            f"mesh {data_parallel}x{model_parallel} has {total} positions but the job "
            f"runs {world} rank(s): start one rank per position (one per card)")
    group = None
    if initialized:
        group = dist.group.WORLD
        if model_parallel > 1:
            for m in range(model_parallel):   # every rank forms every group
                ranks = [d * model_parallel + m for d in range(data_parallel)]
                g = dist.new_group(ranks)
                if rank in ranks:
                    group = g
    device = _group_device(devices[rank] if devices is not None else None)
    logger.debug(f"mesh: {data_parallel} data x {model_parallel} model, rank {rank} on {device}")
    return Mesh(data_parallel, model_parallel, rank, device, group)


# Each parameter starts on a 64-byte boundary of the flat vector: a view of
# it then takes the same vectorized kernel paths (and the same summation
# order in a norm) as a tensor of its own.
FLAT_ALIGN = 16


def _align(n: int) -> int:
    return -(-n // FLAT_ALIGN) * FLAT_ALIGN


@dataclasses.dataclass(frozen=True)
class FlatShard:
    """A flat partition of a list of parameters over the data axis (the
    port's FSDP; `fsdp_param_sharding`).

    The parameters, flattened in order, lie in one f32 vector, each from an
    offset that is a multiple of FLAT_ALIGN (zeros between them), which is
    zero-padded to `shard * n` elements (n the data axis's size); rank
    position i on the data axis holds elements [i * shard, (i + 1) * shard)."""

    shapes: Tuple[torch.Size, ...]
    offsets: Tuple[int, ...]
    shard: int
    index: int
    n: int

    @property
    def padded(self) -> int:
        return self.shard * self.n

    @property
    def lo(self) -> int:
        return self.index * self.shard

    @property
    def hi(self) -> int:
        return self.lo + self.shard

    def pieces(self) -> List[Tuple[int, int, int]]:
        """(parameter index, start, stop) of each parameter's elements within
        this rank's shard, in order; parameters outside it have none."""
        out = []
        for j, (off, shape) in enumerate(zip(self.offsets, self.shapes)):
            a, b = max(off, self.lo), min(off + math.prod(shape), self.hi)
            if a < b:
                out.append((j, a - self.lo, b - self.lo))
        return out


def flat_layout(params: Sequence[torch.Tensor], n: int = 1, index: int = 0) -> FlatShard:
    """The flat vector of `params` split into `n` shards, shard `index`."""
    shapes = tuple(p.shape for p in params)
    offsets, end = [], 0
    for shape in shapes:
        offsets.append(end)
        end = _align(end + math.prod(shape))
    return FlatShard(shapes, tuple(offsets), _align(-(-end // n)), index, n)


def fsdp_param_sharding(mesh: Mesh, params: Sequence[torch.Tensor]) -> FlatShard:
    """Which elements of `params` this rank holds under FSDP (JAX
    `fsdp_param_sharding` :58, which shards each >= 2-D leaf along its
    largest dimension when it divides and replicates the rest).

    The port partitions a flat buffer instead (`FlatShard`): every
    parameter element is held by exactly one rank of the data axis, about
    1/data_parallel of them each (the shards are equal; the last ends in
    zero padding), and nothing is replicated but the optimizer's scalars
    (its update count, the step and skip counts)."""
    return flat_layout(params, mesh.data_parallel, mesh.data_index)


def shard_batch(batch: Dict[str, np.ndarray], mesh: Mesh) -> Dict[str, np.ndarray]:
    """This rank's part of an [accum, B, T] host batch (JAX `shard_batch`
    :78 and `make_global_batch` :120 with `accum=True`, the P(None, data)
    layout of the train step): rows [i * per, (i + 1) * per) of every
    micro-batch, i = the rank's data position, per = B / data_parallel;
    plus `n_labels`, int64 [accum], the label count (labels != -100, at
    least 1) of each whole micro-batch over every rank, which divides each
    rank's token-loss sum (JAX's loss is a token-weighted mean over the
    global micro-batch). Every rank holds the whole host batch, so the count
    costs no collective."""
    B = batch["labels"].shape[1]
    if B % mesh.data_parallel:
        raise ValueError(f"micro-batch of {B} rows does not split over "
                         f"{mesh.data_parallel} data-parallel ranks")
    per = B // mesh.data_parallel
    rows = slice(mesh.data_index * per, (mesh.data_index + 1) * per)
    out = {k: v[:, rows] for k, v in batch.items()}
    counts = (batch["labels"] != -100).reshape(batch["labels"].shape[0], -1).sum(axis=1)
    out["n_labels"] = np.maximum(counts, 1).astype(np.int64)
    return out


# ------------------------------------------------------------- multi-host
def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> bool:
    """Join the job's process group; returns True when it has more than one
    rank (JAX `initialize_multihost` :86).

    The group comes from the arguments (`coordinator_address` a `tcp://`
    or `file://` URL, or JAX's `host:port`; `num_processes`; `process_id`)
    or, without them, from the RANK / WORLD_SIZE / MASTER_ADDR /
    MASTER_PORT / LOCAL_RANK environment that `python -m
    torch.distributed.run` sets; with neither, the process runs alone and
    no group is formed. Unlike JAX, a world of one given explicitly forms a
    group, so that its collectives run. NCCL for `cuda`, where the rank
    takes card LOCAL_RANK (from the arguments: the process id) and raises
    if the host has no such card; gloo for `cpu`. A collective that
    waits longer than `timeout` raises. Idempotent: a process already in a
    group keeps it."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    local = process_id
    if num_processes is None and "WORLD_SIZE" in env:
        init_method = "env://"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
        local = int(env.get("LOCAL_RANK", process_id))
    elif num_processes is None:
        return False
    else:
        if coordinator_address is None or process_id is None:
            raise ValueError("num_processes needs coordinator_address and process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    device = resolve_device(device)
    kw = {}
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if local >= count:
            raise RuntimeError(f"rank {process_id} needs card {local}, but this host has "
                               f"{count} card(s)")
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=timeout, **kw)
    logger.info(f"process group: rank {dist.get_rank()} of {dist.get_world_size()} "
                f"({dist.get_backend()})")
    return dist.get_world_size() > 1


def spawn_ranks(fn: Callable, world: int, *args) -> Optional[Any]:
    """Run `fn(rank, world, address, out, *args)` in `world` spawned
    processes, which rendezvous at `address` (a file store in a temporary
    directory); rank 0 may write a JSON record to the path `out`. Returns
    that record, or None when no rank wrote one. A rank that fails ends the
    others and raises here."""
    with tempfile.TemporaryDirectory(prefix="etude_ranks_") as tmp:
        out = Path(tmp) / "out.json"
        ranks = torch.multiprocessing.start_processes(
            fn, args=(world, f"file://{tmp}/store", str(out), *args), nprocs=world,
            join=False, start_method="spawn")
        while not ranks.join():
            pass
        return json.loads(out.read_text()) if out.exists() else None
