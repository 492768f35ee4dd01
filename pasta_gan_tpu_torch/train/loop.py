"""Training loop (counterpart of `pasta_gan_tpu/train/loop.py`).

One process, one card: host samples are drawn in the JAX loader's order
(per-epoch permutations from `(seed, epoch)`), routed on the card by
`prepare_train_batch`, then Gmain + Dmain (`train_step`) every step and R1
(`d_r1_step`) every `d_reg_interval` steps, from the first.  Each tick
prints one stats line and appends one JSON line to `stats.jsonl`; the run
ends with a network snapshot of G_ema (what `cli/test.py` serves) and a
train-state checkpoint (what `--resume` reads).

Phase times are host wall times of work that ends in a synchronise (the
stats read back each step), so they are what the card took plus what the
host added.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..data.dataset import collate, prepare_train_batch
from ..io.checkpoints import restore_train_state, save_snapshot, save_train_state
from ..runtime.config import TrainConfig, to_json
from .step import GANTrainer


def batch_indices(n: int, batch_size: int, seed: int) -> Iterator[List[int]]:
    """Endless dataset indices, `batch_size` at a time: the stream of
    per-epoch permutations `np.random.default_rng((seed, epoch))`."""
    perms: Dict[int, np.ndarray] = {}
    pos = 0
    while True:
        out = []
        for _ in range(batch_size):
            e = pos // n
            if e not in perms:
                perms = {e: np.random.default_rng((seed, e)).permutation(n)}
            out.append(int(perms[e][pos % n]))
            pos += 1
        yield out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mean(records: List[Dict[str, float]], key: str) -> float:
    vals = [r[key] for r in records if key in r]
    return float(np.mean(vals)) if vals else float("nan")


def training_loop(run_dir: str, dataset, config: TrainConfig, device="cuda", vgg=None,
                  resume: Optional[str] = None, total_kimg: Optional[float] = None, verbose: bool = True):
    """Train until `total_kimg` (default: the config's) thousand images.

    Returns (trainer, state, records): one record per step with its stats
    and phase times ("Timing/data", "Timing/Gmain_Dmain", "Timing/Dreg")."""
    device = torch.device(device)
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "training_options.json"), "w") as f:
        f.write(to_json(config))
    total_kimg = config.total_kimg if total_kimg is None else total_kimg

    trainer = GANTrainer(config, vgg=vgg, device=device, noise_seed=config.random_seed)
    state = trainer.init_state(torch.Generator().manual_seed(config.random_seed))
    if resume is not None:
        restore_train_state(resume, state)
        if verbose:
            print(f'Resumed from "{resume}" at step {state.step}')

    indices = batch_indices(len(dataset), config.batch_size, config.random_seed)
    data_gen = torch.Generator().manual_seed(config.random_seed + 1)
    d_reg_interval = config.d_reg_interval or 0
    cur_nimg = state.step * config.batch_size
    tick_start_nimg, cur_tick, batch_idx = cur_nimg, 0, 0
    start_time = tick_start_time = time.time()
    records: List[Dict[str, float]] = []
    tick_records: List[Dict[str, float]] = []
    stats_file = open(os.path.join(run_dir, "stats.jsonl"), "a")
    if verbose:
        print(f"Training for {total_kimg} kimg (batch {config.batch_size}) on {device}...")

    while True:
        t0 = time.time()
        host = collate([dataset[i] for i in next(indices)])
        batch = prepare_train_batch(host, data_gen, device=device)
        _sync(device)
        t_data = time.time()
        state, stats = trainer.train_step(state, batch)
        rec = {k: float(v) for k, v in stats.items()}
        t_main = time.time()
        rec["Timing/data"] = t_data - t0
        rec["Timing/Gmain_Dmain"] = t_main - t_data
        if d_reg_interval and batch_idx % d_reg_interval == 0:
            state, r1_stats = trainer.d_r1_step(state, batch)
            rec.update({k: float(v) for k, v in r1_stats.items()})
            rec["Timing/Dreg"] = time.time() - t_main
        records.append(rec)
        tick_records.append(rec)
        cur_nimg += config.batch_size
        batch_idx += 1

        done = cur_nimg >= total_kimg * 1000
        if not done and cur_tick != 0 and cur_nimg < tick_start_nimg + config.kimg_per_tick * 1000:
            continue

        tick_end = time.time()
        sec_per_tick = tick_end - tick_start_time
        sec_per_kimg = sec_per_tick / max((cur_nimg - tick_start_nimg) / 1000.0, 1e-8)
        line = {k: _mean(tick_records, k) for k in sorted({k for r in tick_records for k in r})}
        line.update({"Progress/tick": cur_tick, "Progress/kimg": cur_nimg / 1e3, "Progress/step": state.step,
                     "Timing/sec_per_tick": sec_per_tick, "Timing/sec_per_kimg": sec_per_kimg,
                     "Timing/total_sec": tick_end - start_time})
        stats_file.write(json.dumps(line) + "\n")
        stats_file.flush()
        if verbose:
            r1 = f" r1 {line['Loss/r1_penalty']:.4g}" if "Loss/r1_penalty" in line else ""  # only ticks that ran R1
            print(f"tick {cur_tick:<5d} kimg {cur_nimg / 1e3:<8.3f} step {state.step:<6d} "
                  f"time {tick_end - start_time:<8.1f}s sec/kimg {sec_per_kimg:<8.2f} "
                  f"augment {line['Progress/augment_p']:.3f} G/loss {line['Loss/G/loss']:.3f} D/loss {line['Loss/D/loss']:.3f}{r1}", flush=True)
        cur_tick += 1
        tick_start_nimg, tick_start_time, tick_records = cur_nimg, time.time(), []
        if done:
            break
    stats_file.close()

    snap = os.path.join(run_dir, f"network-snapshot-{int(cur_nimg // 1000):06d}.pt")
    save_snapshot(snap, state.G_ema.state_dict(), state.w_avg,
                  {"model": state.G_ema.config, "generator": state.G_ema.variant})
    save_train_state(os.path.join(run_dir, "train-state-latest.pt"), state, dataclasses.asdict(config))
    if verbose:
        print(f"saved {snap} and train-state-latest.pt")
    return trainer, state, records
