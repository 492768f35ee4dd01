"""Training loop (counterpart of `pasta_gan_tpu/train/loop.py`).

One process, one card: host samples come from `InfiniteLoader` in the JAX
loader's order (per-epoch permutations from `(seed, epoch)`, batches built
ahead by worker processes), are routed on the card by `prepare_train_batch`,
then Gmain + Dmain (`train_step`) every step, Greg (`g_pl_step`) every
`g_reg_interval` steps when `pl_weight > 0`, and R1 (`d_r1_step`) every
`d_reg_interval` steps, each from the first, in that order.  Each step's
stats and phase times go into a `Collector`; each tick prints one stats
line from it and appends
one row to `stats.jsonl` through `JsonlLogger`: {name: {num, mean, std}},
`timestamp`, the JAX loop's flat extras (`Progress/tick`, `Progress/kimg`,
`Timing/sec_per_tick`, `Timing/sec_per_kimg`, `Timing/total_sec`) and
`Progress/step`, which the JAX loop does not write.  Every `network_snapshot_ticks` ticks
(tick > 0), and when the run ends, it saves a network snapshot of G_ema
(`network-snapshot-<kimg>.pt`, what `cli/test.py` serves) and a train-state
checkpoint (`train-state-latest.pt`, what `--resume` reads).  `resume` is
such a checkpoint (a zip file: the whole state is restored) or a network
pickle (a legacy TF export or a reference snapshot: `io/transfer.py` copies
the tensors whose names and shapes agree into the fresh state).  Unless
`image_snapshot_ticks` is 0, it writes the image grids of `SnapshotGrids`
once at the start and every `image_snapshot_ticks` ticks, tick 0 and the
last included.

Phase times are host wall times of work that ends in a synchronise (the
stats read back each step), so they are what the card took plus what the
host added; `Timing/data` is the wait for the loader plus the routing.

Several cards (`group`, a `torch.distributed` process group of one process
per card): as in the JAX loop's multi-process mode, each rank loads and
routes its 1/world of the global batch (`config.batch_size`, which the EMA
and ADA formulas keep reading) at the stream positions `start + j*world +
rank`, with its own erasure draws; the state is made on every rank from the
same seed (or resumed from the same file) and then replicated from rank 0;
the step averages gradients and stats over the ranks, so every rank's stats
are the means; before every snapshot G and D are checked bitwise equal on
every rank (`parallel.mesh.check_replication_consistency`), and only rank 0
writes: training_options.json, stats.jsonl, the grids, the snapshots and the
train state.
"""

from __future__ import annotations

import contextlib
import dataclasses
import multiprocessing
import os
import queue
import threading
import time
import traceback
import zipfile
from multiprocessing import shared_memory
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.dataset import collate, prepare_train_batch, prepare_tryon_grid_batch
from ..io.checkpoints import restore_train_state, save_snapshot, save_train_state
from ..parallel import mesh
from ..runtime.config import TrainConfig, to_json
from ..runtime.stats import Collector, JsonlLogger
from ..utils import parsing_to_rgb, save_image_grid
from .step import GANTrainer


def batch_indices(n: int, batch_size: int, seed: int, b: int, rank: int = 0, world: int = 1) -> List[int]:
    """Dataset indices of rank `rank`'s batch b of `batch_size`: stream
    positions b*batch_size*world + j*world + rank (j < batch_size) of the
    per-epoch permutations `np.random.default_rng((seed, epoch)).permutation(n)`;
    the world's ranks take the global batch b between them
    (`pasta_gan_tpu/train/loop.py:InfiniteLoader._batch_indices`)."""
    perms: Dict[int, np.ndarray] = {}
    out = []
    start = b * batch_size * world
    for j in range(batch_size):
        pos = start + j * world + rank
        e = pos // n
        if e not in perms:
            perms[e] = np.random.default_rng((seed, e)).permutation(n)
        out.append(int(perms[e][pos % n]))
    return out


def _to_shared(batch: Dict[str, np.ndarray]):
    """Copy a collated batch into a new shared-memory block; returns (block
    name, [(key, shape, dtype, offset)]).  The receiver unlinks the block."""
    size = sum(v.nbytes for v in batch.values())
    shm = shared_memory.SharedMemory(create=True, size=max(size, 1))
    layout, off = [], 0
    for k, v in batch.items():
        np.ndarray(v.shape, v.dtype, buffer=shm.buf, offset=off)[...] = v
        layout.append((k, v.shape, v.dtype.str, off))
        off += v.nbytes
    shm.close()
    return shm.name, layout


def _from_shared(name: str, layout) -> Dict[str, np.ndarray]:
    """The batch a worker wrote into block `name`, copied out; the block is unlinked."""
    shm = shared_memory.SharedMemory(name=name)
    try:
        return {k: np.ndarray(shape, np.dtype(dt), buffer=shm.buf, offset=off).copy() for k, shape, dt, off in layout}
    finally:
        shm.close()
        shm.unlink()


def _loader_worker(dataset, batch_size: int, seed: int, rank: int, world: int, wid: int, num_workers: int, out,
                   stop) -> None:
    """Build batches wid, wid + num_workers, ... into `out` (blocks when full)
    until `stop` is set; a failure is sent as its traceback."""
    b = wid
    try:
        while not stop.is_set():
            batch = collate([dataset[i] for i in batch_indices(len(dataset), batch_size, seed, b, rank, world)])
            out.put(("batch", _to_shared(batch)))
            b += num_workers
    except Exception:
        out.put(("error", traceback.format_exc()))


class InfiniteLoader:
    """Endless shuffled batches of collated host samples, built ahead by
    `num_workers` worker processes (the counterpart of `pasta_gan_tpu/train/
    loop.py:InfiniteLoader` on one process, which uses threads).

    Batch b holds the dataset indices `batch_indices(len(dataset),
    batch_size, seed, b, rank, world)`: `batch_size` is the per-rank batch.  Worker w builds the batches b = w (mod
    num_workers) in order and writes each into a shared-memory block, whose
    name goes into the worker's own bounded queue of
    ceil((prefetch + num_workers) / num_workers) batches; a receiving thread
    takes batch b from queue b mod num_workers, so batches come out in order
    of b, copies it out of the block and holds up to 2 batches for
    `__next__`.  Why processes and shared memory (PERF.md, PR 8, on an H100
    machine): threads building samples hold the interpreter lock for most
    of a sample's ~12 ms and slowed the loop's own kernel dispatch (53-88x
    in `scripts/loader_contention.py`; Gmain+Dmain 807-966 ms against 650);
    batches pickled through the queues left 67-92 ms of `Timing/data` a
    step, shared-memory blocks 24-29 ms (the routing alone).
    The workers are started with "spawn" (the parent holds CUDA and threads),
    so `dataset` must pickle.  A worker's failure is raised by `__next__`
    with its traceback; `close()` (or leaving a `with` block) stops them and
    unlinks every block still queued."""

    def __init__(self, dataset, batch_size: int, seed: int = 0, prefetch: int = 4, num_workers: int = 1,
                 rank: int = 0, world: int = 1):
        self.num_workers = max(1, num_workers)
        ctx = multiprocessing.get_context("spawn")
        depth = -(-(prefetch + self.num_workers) // self.num_workers)
        self._stop_workers = ctx.Event()
        self._queues = [ctx.Queue(maxsize=depth) for _ in range(self.num_workers)]
        self._procs = [ctx.Process(target=_loader_worker, daemon=True,
                                   args=(dataset, batch_size, seed, rank, world, w, self.num_workers, q,
                                         self._stop_workers))
                       for w, q in enumerate(self._queues)]
        for p in self._procs:
            p.start()
        self._ready: queue.Queue = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self._receiver = threading.Thread(target=self._receive, daemon=True)
        self._receiver.start()

    def _receive(self) -> None:
        b = 0
        try:
            while not self._stop.is_set():
                w = b % self.num_workers
                try:
                    kind, payload = self._queues[w].get(timeout=0.5)
                except queue.Empty:
                    if self._procs[w].is_alive():
                        continue
                    kind, payload = "error", f"loader worker {w} exited (code {self._procs[w].exitcode}) before batch {b}"
                if kind == "batch":
                    payload = _from_shared(*payload)
                elif not payload.startswith("loader worker"):
                    payload = f"loader worker {w} failed building batch {b}:\n{payload}"
                self._put((kind, payload))
                if kind == "error":
                    return
                b += 1
        except Exception:  # handed to the consumer, which raises it
            self._put(("error", f"the loader's receiving thread failed at batch {b}:\n{traceback.format_exc()}"))

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._ready.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        kind, payload = self._ready.get()
        if kind == "error":
            self._ready.put((kind, payload))  # every later call raises it too
            raise RuntimeError(payload)
        return payload

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _drain(self) -> None:
        for q in self._queues:
            while True:
                try:
                    kind, payload = q.get_nowait()
                except queue.Empty:
                    break
                if kind == "batch":
                    _from_shared(*payload)

    def close(self) -> None:
        """Stop the receiver and the workers; a worker blocked on its full
        queue is let finish its put, whose block is unlinked here."""
        self._stop.set()
        self._receiver.join(timeout=60)
        self._stop_workers.set()
        deadline = time.time() + 30
        while any(p.is_alive() for p in self._procs) and time.time() < deadline:
            self._drain()
            for p in self._procs:
                p.join(timeout=0.05)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=60)
        self._drain()
        for q in self._queues:
            q.close()
            q.cancel_join_thread()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SnapshotGrids:
    """The training run's image grids (`pasta_gan_tpu/train/loop.py:184-262`),
    written as PNGs into the run directory from a fixed batch: the first
    grid_n = min(16, batch, len(dataset)) samples, routed once by
    `prepare_train_batch` with erasure draws from a CPU generator seeded 1234.

    At construction: `reals.png`, `init_denorm_upper.png`,
    `init_denorm_lower.png` and `init_retain.png`.  Each `save(G, tag)`:
    `fakes<tag>.png` (G's finetune images), `parsing<tag>.png` (its parsing
    argmax through the label palette) and `tryon_grid<tag>.png`, a gnum x gnum
    matrix (gnum = min(tryon_grid_n, grid_n), at least 2) of person r wearing
    provider c's garments, routed by `prepare_tryon_grid_batch`: the
    provider's pants in the first third of the rows, both pieces in the
    second, the top in the last.  G runs with the fixed noise maps
    (`noise_mode="const"`)."""

    def __init__(self, run_dir: str, dataset, config: TrainConfig, device):
        self.run_dir, self.device = run_dir, device
        self.grid_n = min(16, config.batch_size, len(dataset))
        self.gnum = min(config.tryon_grid_n, self.grid_n)
        self.host = collate([dataset[i] for i in range(self.grid_n)])
        self.batch = prepare_train_batch(self.host, torch.Generator().manual_seed(1234), device=device)
        for name, key in (("reals", "real_img"), ("init_denorm_upper", "denorm_upper_img"),
                          ("init_denorm_lower", "denorm_lower_img"), ("init_retain", "retain")):
            save_image_grid(self.batch[key].cpu().numpy(), os.path.join(run_dir, f"{name}.png"))

    @torch.no_grad()
    def _forward(self, G, b):
        _, finetune, parsing = G(None, b["style_input"], b["retain"], b["pose"], b["denorm_upper_img"],
                                 b["denorm_lower_img"], b["denorm_upper_mask"], b["denorm_lower_mask"],
                                 noise_mode="const")
        return finetune.float().cpu().numpy(), parsing.float().cpu().numpy()

    def save(self, G, tag: str) -> None:
        fakes, parsing = self._forward(G, self.batch)
        save_image_grid(fakes, os.path.join(self.run_dir, f"fakes{tag}.png"))
        save_image_grid(parsing_to_rgb(parsing), os.path.join(self.run_dir, f"parsing{tag}.png"), drange=(0, 1))
        if self.gnum < 2:
            return
        g, gap = self.gnum, max(self.gnum // 3, 1)
        garment = {k: v[:g] for k, v in self.host.items()}
        rows = []
        for r in range(g):
            person = {k: np.repeat(v[r:r + 1], g, axis=0) for k, v in self.host.items()}
            swap = "lower" if r < gap else ("full" if r < 2 * gap else "upper")
            rows.append(self._forward(G, prepare_tryon_grid_batch(person, garment, swap=swap, device=self.device))[0])
        save_image_grid(np.concatenate(rows, axis=0), os.path.join(self.run_dir, f"tryon_grid{tag}.png"), grid_cols=g)


def _save_snapshot(run_dir: str, state, config: TrainConfig, cur_nimg: int, verbose: bool) -> None:
    snap = os.path.join(run_dir, f"network-snapshot-{cur_nimg // 1000:06d}.pt")
    save_snapshot(snap, state.G_ema.state_dict(), state.w_avg,
                  {"model": state.G_ema.config, "generator": state.G_ema.variant})
    save_train_state(os.path.join(run_dir, "train-state-latest.pt"), state, dataclasses.asdict(config))
    if verbose:
        print(f"saved {snap} and train-state-latest.pt at step {state.step}", flush=True)


def replicate_state(state, group) -> None:
    """Rank 0's train state on every rank of `group`: the networks, the
    optimizers' moments on the state's device (on the card, Adam keeps its
    step counts on the host; they are equal on every rank) and the scalar
    state."""
    if group is None:
        return
    for module in (state.G, state.D, state.G_ema):
        mesh.replicate_module(module, group=group)
    moments = [v for opt in (state.g_opt, state.d_opt) for per in opt.state.values()
               for v in per.values() if torch.is_tensor(v) and v.device == state.w_avg.device]
    mesh.replicate_tensors([*moments, state.w_avg, state.pl_mean, state.ada_p, state.ada_signs_sum,
                            state.ada_signs_count], group=group)


def training_loop(run_dir: Optional[str], dataset, config: TrainConfig, device="cuda", vgg=None,
                  resume: Optional[str] = None, verbose: bool = True, group=None):
    """Train until `config.total_kimg` thousand images, on the ranks of
    `group` (None: this process alone).  Only rank 0 writes into `run_dir`;
    the other ranks may pass None.

    Returns (trainer, state, records): one record per step with its stats
    and phase times ("Timing/data", "Timing/Gmain_Dmain", "Timing/Greg",
    "Timing/Dreg")."""
    device = torch.device(device)
    rank, world = mesh.rank(group), mesh.world(group)
    main = rank == 0
    verbose = verbose and main
    if config.batch_size % world:
        raise ValueError(f"the global batch {config.batch_size} does not split over {world} ranks")
    if main:
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "training_options.json"), "w") as f:
            f.write(to_json(config))
    total_kimg = config.total_kimg

    trainer = GANTrainer(config, vgg=vgg, device=device, noise_seed=config.random_seed, group=group)
    state = trainer.init_state(torch.Generator().manual_seed(config.random_seed))
    if resume is not None:
        if zipfile.is_zipfile(resume):  # this package's train state (a torch.save zip)
            restore_train_state(resume, state)
            if verbose:
                print(f'Resumed from "{resume}" at step {state.step}')
        else:  # a network pickle: transfer learning, name and shape matches copy in
            from ..io import transfer

            transfer.transfer_from_network_pickle(state, resume, verbose=verbose)
    replicate_state(state, group)

    data_seed = config.random_seed + 1
    data_gen = torch.Generator().manual_seed(data_seed if group is None else mesh.rank_seed(data_seed, rank))
    d_reg_interval = config.d_reg_interval or 0
    g_reg_interval = (config.g_reg_interval or 0) if config.loss.pl_weight > 0 else 0
    snap_ticks, img_ticks = config.network_snapshot_ticks, config.image_snapshot_ticks
    cur_nimg = state.step * config.batch_size
    tick_start_nimg, cur_tick, batch_idx = cur_nimg, 0, 0
    start_time = tick_start_time = time.time()
    records: List[Dict[str, float]] = []
    collector = Collector()
    if verbose:
        ranks = f", {world} ranks of {config.batch_size // world}" if world > 1 else ""
        print(f"Training for {total_kimg} kimg (batch {config.batch_size}{ranks}) on {device}...")
    loader = InfiniteLoader(dataset, config.batch_size // world, seed=config.random_seed,
                            num_workers=config.data_workers, rank=rank, world=world)
    jsonl = JsonlLogger(os.path.join(run_dir, "stats.jsonl")) if main else contextlib.nullcontext()
    with loader, jsonl:
        grids = SnapshotGrids(run_dir, dataset, config, device) if img_ticks and main else None
        while True:
            t0 = time.time()
            batch = prepare_train_batch(next(loader), data_gen, device=device)
            _sync(device)
            t_data = time.time()
            state, stats = trainer.train_step(state, batch)
            rec = {k: float(v) for k, v in stats.items()}
            t_main = time.time()
            rec["Timing/data"] = t_data - t0
            rec["Timing/Gmain_Dmain"] = t_main - t_data
            if g_reg_interval and batch_idx % g_reg_interval == 0:
                t1 = time.time()
                state, pl_stats = trainer.g_pl_step(state, batch)
                rec.update({k: float(v) for k, v in pl_stats.items()})
                rec["Timing/Greg"] = time.time() - t1
            if d_reg_interval and batch_idx % d_reg_interval == 0:
                t1 = time.time()
                state, r1_stats = trainer.d_r1_step(state, batch)
                rec.update({k: float(v) for k, v in r1_stats.items()})
                rec["Timing/Dreg"] = time.time() - t1
            records.append(rec)
            collector.report_dict(rec)
            cur_nimg += config.batch_size
            batch_idx += 1

            done = cur_nimg >= total_kimg * 1000
            if not done and cur_tick != 0 and cur_nimg < tick_start_nimg + config.kimg_per_tick * 1000:
                continue

            tick_end = time.time()
            collector.update()
            sec_per_tick = tick_end - tick_start_time
            sec_per_kimg = sec_per_tick / max((cur_nimg - tick_start_nimg) / 1000.0, 1e-8)
            if main:
                jsonl.write(collector, **{
                    "Progress/tick": cur_tick, "Progress/kimg": cur_nimg / 1e3,
                    "Timing/sec_per_tick": sec_per_tick, "Timing/sec_per_kimg": sec_per_kimg,
                    "Timing/total_sec": tick_end - start_time, "Progress/step": state.step,
                })
            if verbose:
                # only ticks that ran R1 or Greg have their penalties
                r1 = "".join(f" {name} {collector.mean(key):.4g}" for name, key in (
                    ("pl", "Loss/pl_penalty"), ("r1", "Loss/r1_penalty")) if key in collector.names())
                print(f"tick {cur_tick:<5d} kimg {cur_nimg / 1e3:<8.3f} step {state.step:<6d} "
                      f"time {tick_end - start_time:<8.1f}s sec/kimg {sec_per_kimg:<8.2f} "
                      f"augment {collector.mean('Progress/augment_p'):.3f} G/loss {collector.mean('Loss/G/loss'):.3f} "
                      f"D/loss {collector.mean('Loss/D/loss'):.3f}{r1}", flush=True)
            if grids is not None and (done or cur_tick % img_ticks == 0):
                grids.save(state.G_ema, f"{cur_nimg // 1000:06d}")
            # the JAX loop's cadence; the port also saves a run that ends in tick 0
            if done or (snap_ticks and cur_tick > 0 and cur_tick % snap_ticks == 0):
                # reference misc.check_ddp_consistency before every snapshot (JAX loop :365-370)
                mesh.check_replication_consistency(state.G, group, prefix="G.")
                mesh.check_replication_consistency(state.D, group, prefix="D.")
                if main:
                    _save_snapshot(run_dir, state, config, cur_nimg, verbose)
            cur_tick += 1
            tick_start_nimg, tick_start_time = cur_nimg, time.time()
            if done:
                break
    return trainer, state, records
