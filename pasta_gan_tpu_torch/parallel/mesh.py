"""Several cards (counterpart of `pasta_gan_tpu/parallel/mesh.py`).

The JAX package runs one program over a 1-D `data` mesh: parameters stay
replicated, the batch is split over the mesh, and `lax.pmean` in the step is
the one collective.  Its multi-process mode (`jax.distributed.initialize`,
`jax.process_index()`, a rank-strided loader) is PyTorch's idiom: one
process per card under `torchrun` (`RANK`, `WORLD_SIZE`, `LOCAL_RANK` in the
environment), each holding a replica of the networks and 1/world of the
global batch, with `torch.distributed` collectives over NCCL (CUDA) or gloo
(the CPU, or several ranks sharing one card).

* `initialize_distributed` — `:90`; a no-op at world 1, as in JAX.
* `world`, `rank` — `jax.process_count()`, `jax.process_index()`.
* `all_reduce_mean` — `lax.pmean`: flattened into buckets, summed, divided
  by the world size; the identity without a process group.
* `replicate_module`, `replicate_tensors` — `replicate` (`:47`): rank 0's
  parameters and buffers broadcast to every rank.
* `check_replication_consistency` — `:105`: every leaf bitwise equal to
  rank 0's, else AssertionError naming the first leaf that differs.
* `shard_batch`, `data_parallel_devices` — `:30`, `:25`: the contiguous
  chunk of a global batch that one device serves (`PartitionSpec("data")`),
  and the devices one process serves over (every visible CUDA device).

`local_value` (`:77`) has no counterpart: in one process per card every
tensor a process holds is its own replica, readable as it is.

The training step takes its gradients with `torch.autograd.grad` (and a
double backward for R1 and Greg), so it calls `all_reduce_mean` at each of
JAX's `_pmean` sites instead of wrapping the networks in
`DistributedDataParallel` (`train/step.py`).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
BUCKET_BYTES = 32 << 20  # elements of one collective call: few calls, a bounded staging copy


def env_rank_world():
    """(RANK, WORLD_SIZE, LOCAL_RANK) of the torchrun environment; (0, 1, 0) outside it."""
    return (int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1)),
            int(os.environ.get("LOCAL_RANK", 0)))


def initialize_distributed(backend: str, init_method: str = "env://", world_size: Optional[int] = None,
                           rank: Optional[int] = None):
    """Join the process group of `world_size` ranks (default: the torchrun
    environment's) over `backend`, "nccl" or "gloo", and return it; None at
    world 1, where nothing is distributed.  The backend is the caller's: no
    other is tried when it fails."""
    env_rank, env_world, _ = env_rank_world()
    world_size = env_world if world_size is None else world_size
    rank = env_rank if rank is None else rank
    if world_size <= 1:
        return None
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {', '.join(BACKENDS)}")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return dist.group.WORLD


def world(group=None) -> int:
    """Ranks in `group` (default: the process group); 1 when none was made."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    """This process's rank in `group`; 0 when no group was made."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def rank_seed(seed: int, rank: int) -> int:
    """A rank's own seed drawn from `seed`: the counterpart of folding the
    device's `axis_index` into the step's key."""
    return int(np.random.SeedSequence((seed, 2, rank)).generate_state(1)[0])


def _buckets(tensors: Sequence[torch.Tensor]) -> Iterable[List[int]]:
    """Indices of `tensors` in runs of one device and dtype, each of at most
    `BUCKET_BYTES` (a larger tensor alone)."""
    run: List[int] = []
    size = 0
    for i, t in enumerate(tensors):
        if run and (t.device != tensors[run[0]].device or t.dtype != tensors[run[0]].dtype
                    or size + t.numel() * t.element_size() > BUCKET_BYTES):
            yield run
            run, size = [], 0
        run.append(i)
        size += t.numel() * t.element_size()
    if run:
        yield run


def _flat(ts: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for t in ts])


@torch.no_grad()
def _unflat(flat: torch.Tensor, ts: Sequence[torch.Tensor]) -> None:
    off = 0
    for t in ts:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


def all_reduce_mean(tensors: Sequence[torch.Tensor], group=None):
    """`lax.pmean` in place over the ranks of `group`: the tensors are
    flattened into buckets, each bucket is summed over the ranks and divided
    by their count.  Every rank gets the same bits (the sum is reduced once
    and handed to all).  Without a group (world 1) it is the identity.
    Returns `tensors`."""
    tensors = list(tensors)
    if group is None or not tensors:
        return tensors
    n = dist.get_world_size(group)
    for idx in _buckets(tensors):
        ts = [tensors[i] for i in idx]
        flat = _flat(ts)
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(n)
        _unflat(flat, ts)
    return tensors


def replicate_tensors(tensors: Sequence[torch.Tensor], src: int = 0, group=None) -> None:
    """Rank `src`'s values of `tensors` written into every rank's, in place
    (buckets broadcast from `src`); nothing without a group."""
    tensors = list(tensors)
    if group is None:
        return
    for idx in _buckets(tensors):
        ts = [tensors[i] for i in idx]
        flat = _flat(ts)
        dist.broadcast(flat, src=src, group=group)
        _unflat(flat, ts)


def replicate_module(module: torch.nn.Module, src: int = 0, group=None) -> torch.nn.Module:
    """`replicate`: `module`'s parameters and buffers set to rank `src`'s on every rank."""
    replicate_tensors([*module.parameters(), *module.buffers()], src=src, group=group)
    return module


def check_replication_consistency(module: torch.nn.Module, group=None, prefix: str = "") -> None:
    """`misc.check_ddp_consistency`: every parameter and buffer of `module`
    bitwise equal to rank 0's.  Every rank takes part in each broadcast and
    raises the same AssertionError, naming the first leaf that differs and
    the lowest rank where it does."""
    if group is None:
        return
    items = list(module.state_dict(keep_vars=True).items())
    if not items:
        return
    tensors = [t.detach() for _, t in items]
    first_bad = len(tensors)
    for idx in _buckets(tensors):
        ts = [tensors[i] for i in idx]
        ref = _flat(ts)
        dist.broadcast(ref, src=0, group=group)
        off = 0
        for i, t in zip(idx, ts):
            n = t.numel()
            if i < first_bad and not torch.equal(ref[off:off + n], t.reshape(-1)):
                first_bad = i
            off += n
    n_ranks, me = dist.get_world_size(group), dist.get_rank(group)
    flags = torch.zeros(n_ranks, dtype=torch.float64, device=tensors[0].device)
    flags[me] = first_bad
    dist.all_reduce(flags, op=dist.ReduceOp.SUM, group=group)
    flags = flags.tolist()
    leaf = int(min(flags))
    if leaf < len(tensors):
        name = prefix + items[leaf][0]
        raise AssertionError(f"replication mismatch at {name}: device 0 vs device {flags.index(leaf)}")


def shard_batch(batch: Dict, rank: int, world: int) -> Dict:
    """Rank `rank`'s contiguous 1/`world` of each value's first axis (the
    data axis of `PartitionSpec("data")`); the batch must divide."""
    n = len(next(iter(batch.values())))
    if n % world:
        raise ValueError(f"a batch of {n} does not split over {world} devices")
    k = n // world
    return {key: v[rank * k:(rank + 1) * k] for key, v in batch.items()}


def data_parallel_devices() -> List[torch.device]:
    """The devices one serving process splits its batch over: every visible CUDA device."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("data-parallel serving needs CUDA devices, and torch.cuda.device_count() is 0")
    return [torch.device("cuda", i) for i in range(n)]
