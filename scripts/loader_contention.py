#!/usr/bin/env python3
"""How host data loading competes with the training loop's kernel dispatch.

  python scripts/loader_contention.py [--data tests/fixtures/upt_mini] [--batch 32] [--workers 3]

The training loop's host thread launches ~13 000 device operations a step,
so anything that holds the interpreter lock in the same process slows it.
This script measures, on the card when there is one (else on the CPU, and
says so):

* `dispatch`: the median ms of 2000 small in-place device operations (plus
  a synchronise), alone and while batches of `--batch` UPT samples
  (`UvitonDatasetFull`) are built by (a) `--workers` threads in this
  process, as the JAX package's loader builds them, and (b) the port's
  `InfiniteLoader` (worker processes, batches handed over in shared
  memory), with the loader's ms a batch beside it;
* `handover`: the ms to receive one ready collated batch from a spawned
  process (median of 5) through a `multiprocessing.Queue` (pickled through
  a pipe) and through a shared-memory block (`train/loop.py:_from_shared`),
  and the dispatch time beside a thread that receives them back to back.

Every line is tagged with the device (and, on a card, its name and power
limit).
"""

import argparse
import multiprocessing
import os
import queue
import statistics
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from pasta_gan_tpu_torch.data.dataset import UvitonDatasetFull, collate  # noqa: E402
from pasta_gan_tpu_torch.train import loop  # noqa: E402


def device_tag():
    if not torch.cuda.is_available():
        return torch.device("cpu"), "CPU (no card: not a device number)"
    name = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return torch.device("cuda"), name


def dispatch_ms(x, n=2000):
    """Median ms of n in-place device operations and a synchronise, over 5 rounds."""
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            x.add_(1.0)
        if x.is_cuda:
            torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def thread_batches(dataset, batch, workers, stop, made):
    """`workers` threads building shuffled batches until `stop` is set."""
    def work(w):
        b = w
        while not stop.is_set():
            collate([dataset[i] for i in loop.batch_indices(len(dataset), batch, 0, b)])
            made.append(time.perf_counter())
            b += workers
    threads = [threading.Thread(target=work, args=(w,), daemon=True) for w in range(workers)]
    for t in threads:
        t.start()
    return threads


def _put_until(q, batch, shared, stop):
    while not stop.is_set():
        q.put(loop._to_shared(batch) if shared else batch)


def handover(batch, x):
    """{way: (median ms to receive one ready batch, dispatch ms while a thread
    receives batches as fast as they come)}, pickled through a queue and in
    shared memory."""
    ctx = multiprocessing.get_context("spawn")
    out = {}
    for shared in (False, True):
        q, stop = ctx.Queue(maxsize=2), ctx.Event()
        p = ctx.Process(target=_put_until, args=(q, batch, shared, stop), daemon=True)
        p.start()

        def get(timeout=None):
            item = q.get(timeout=timeout)
            return loop._from_shared(*item) if shared else item

        get()
        times = []
        for _ in range(5):
            time.sleep(0.5)  # a batch is ready: time the receive alone
            t0 = time.perf_counter()
            get()
            times.append((time.perf_counter() - t0) * 1e3)
        done = threading.Event()

        def receive():
            while not done.is_set():
                get()

        r = threading.Thread(target=receive, daemon=True)
        r.start()
        busy = dispatch_ms(x)
        done.set()
        r.join(timeout=30)
        stop.set()
        while p.is_alive():  # let a blocked put finish, and unlink what it queued
            try:
                get(timeout=0.5)
            except queue.Empty:
                pass
        while True:
            try:
                get(timeout=0.5)
            except queue.Empty:
                break
        out["shared-memory block" if shared else "pickled queue"] = (statistics.median(times), busy)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", default=os.path.join("tests", "fixtures", "upt_mini"))
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--workers", type=int, default=3)
    args = ap.parse_args()
    dev, tag = device_tag()
    x = torch.zeros(16, device=dev)
    dataset = UvitonDatasetFull(args.data)
    alone = dispatch_ms(x)
    print(f"dispatch alone: {alone:.2f} ms for 2000 operations [{tag}]", flush=True)

    stop, made = threading.Event(), []
    threads = thread_batches(dataset, args.batch, args.workers, stop, made)
    while len(made) < 1:
        time.sleep(0.05)
    t0, n0 = time.perf_counter(), len(made)
    busy = dispatch_ms(x)
    time.sleep(2.0)
    rate = (time.perf_counter() - t0) * 1e3 / max(len(made) - n0, 1)
    stop.set()
    for t in threads:
        t.join()
    print(f"dispatch beside {args.workers} loader threads: {busy:.2f} ms ({busy / alone:.2f}x alone); the threads "
          f"built a batch of {args.batch} every {rate:.1f} ms [{tag}]", flush=True)

    with loop.InfiniteLoader(dataset, args.batch, num_workers=args.workers) as loader:
        next(loader)
        t0 = time.perf_counter()
        busy = dispatch_ms(x)
        n = 1
        while time.perf_counter() - t0 < 2.0:
            next(loader)
            n += 1
        rate = (time.perf_counter() - t0) * 1e3 / n
    print(f"dispatch beside InfiniteLoader ({args.workers} worker processes, shared memory): {busy:.2f} ms "
          f"({busy / alone:.2f}x alone); it delivered a batch of {args.batch} every {rate:.1f} ms [{tag}]", flush=True)

    batch = collate([dataset[i % len(dataset)] for i in range(args.batch)])
    mb = sum(v.nbytes for v in batch.values()) / 1e6
    for how, (ms, busy) in handover(batch, x).items():
        print(f"handover of a {mb:.1f} MB batch through a {how}: {ms:.1f} ms to receive (median of 5); dispatch "
              f"beside a thread receiving them back to back {busy:.2f} ms ({busy / alone:.2f}x alone) [{tag}]",
              flush=True)


if __name__ == "__main__":
    main()
