"""Ranks of a two-process gloo group on the CPU, for the port's
data-parallel tests (tests/test_torch_parallel.py, tests/test_torch_dp_cli.py).

Each function runs in a process of its own, spawned by `spawn_ranks`, and
imports no JAX: the parent hands it numpy inputs and reads its results back
from files.  The ranks meet through a `file://` rendezvous in the test's
tmp_path.
"""

from __future__ import annotations

import os
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

WORLD = 2


def spawn_ranks(fn, *args, world: int = WORLD):
    """Start `fn(rank, world, *args)` in `world` spawned processes; returns
    the context, whose `join()` raises a rank's failure."""
    return mp.start_processes(fn, args=(world, *args), nprocs=world, join=False, start_method="spawn")


def join(ctx, timeout: float = 300.0) -> None:
    """Wait for every rank; a rank's exception is raised here, a hang fails at `timeout`."""
    import time

    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the ranks did not finish within {timeout:.0f} s")


def _group(rank: int, world: int, rdzv: str):
    from pasta_gan_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    return mesh.initialize_distributed("gloo", init_method=f"file://{rdzv}", world_size=world, rank=rank)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def mesh_rank(rank: int, world: int, rdzv: str, inputs: str, out: str) -> None:
    """The reduce, the two steps, Greg, the consistency check and
    `replicate_state` of tests/test_torch_parallel.py on this rank's half of
    the batch; its results go to `out`/rank<rank>.pt."""
    from pasta_gan_tpu_torch.nn.discriminator import Discriminator
    from pasta_gan_tpu_torch.parallel import mesh
    from pasta_gan_tpu_torch.train.loop import replicate_state
    from pasta_gan_tpu_torch.train.step import GANTrainer
    from pasta_gan_tpu_torch.train.vgg import VGG19Features

    group = _group(rank, world, rdzv)
    d = torch.load(inputs, weights_only=False)
    res = {}

    # all_reduce_mean of a small D's gradients on this rank's samples
    small = Discriminator(**d["small_cfg"])
    small.load_state_dict(d["small_sd"], strict=True)
    part = mesh.shard_batch({"img": d["small_img"], "c": d["small_c"]}, rank, world)
    loss = torch.nn.functional.softplus(small(_nchw(part["img"]), torch.from_numpy(part["c"]))).mean()
    names = [n for n, _ in small.named_parameters()]
    grads = list(torch.autograd.grad(loss, list(small.parameters())))
    mesh.all_reduce_mean(grads, group)
    res["reduce"] = dict(zip(names, grads))

    # one train_step, then one d_r1_step, on this rank's half of the global batch
    vgg = VGG19Features()
    vgg.load_state_dict(d["vgg_sd"], strict=True)
    trainer = GANTrainer(d["config"], vgg=vgg.requires_grad_(False).eval(), device="cpu", group=group)
    G, D = trainer.build_networks()
    G.load_state_dict(d["G"], strict=True)
    D.load_state_dict(d["D"], strict=True)
    state = trainer.init_state(G=G, D=D)
    mesh.replicate_module(state.G, group=group)
    batch = {k: torch.from_numpy(v) for k, v in mesh.shard_batch(d["batch"], rank, world).items()}
    state, stats = trainer.train_step(state, batch)
    res["step_stats"] = {k: float(v) for k, v in stats.items()}
    res["step"] = {name: {k: v.clone() for k, v in getattr(state, name).state_dict().items()}
                   for name in ("G", "D", "G_ema")}
    res["w_avg"] = state.w_avg.clone()
    res["signs"] = (float(state.ada_signs_sum), float(state.ada_signs_count))
    state, r1 = trainer.d_r1_step(state, batch)
    res["r1_stats"] = {k: float(v) for k, v in r1.items()}
    res["r1"] = {name: {k: v.clone() for k, v in getattr(state, name).state_dict().items()} for name in ("G", "D")}

    # one Greg step (pl_weight > 0) from the initial weights and pl_mean, with JAX's path-length noise of the
    # device of this rank's index
    greg = GANTrainer(d["config_pl"], vgg=vgg, device="cpu", group=group)
    G, D = greg.build_networks()
    G.load_state_dict(d["G"], strict=True)
    D.load_state_dict(d["D"], strict=True)
    gstate = greg.init_state(G=G, D=D)
    gstate.pl_mean.fill_(d["pl_mean"])
    gstate, gstats = greg.g_pl_step(gstate, batch, pl_noise=torch.from_numpy(d["pl_noise"][rank]))
    res["greg_stats"] = {k: float(v) for k, v in gstats.items()}
    res["greg"] = {k: v.clone() for k, v in gstate.G.state_dict().items()}
    res["pl_mean"] = gstate.pl_mean.clone()

    # the replicas agree; then rank 1's D differs in one leaf
    mesh.check_replication_consistency(state.G, group, prefix="G.")
    mesh.check_replication_consistency(state.D, group, prefix="D.")
    if rank == 1:
        with torch.no_grad():
            dict(state.D.named_parameters())[d["perturb"]].add_(1e-3)
    try:
        mesh.check_replication_consistency(state.D, group, prefix="D.")
        res["perturbed"] = None
    except AssertionError as e:
        res["perturbed"] = str(e)

    # train/loop.py:replicate_state puts rank 0's state back on rank 1, Adam's moments included
    if rank == 1:
        with torch.no_grad():
            next(iter(state.d_opt.state.values()))["exp_avg"].add_(1.0)
            state.w_avg.add_(1.0)
    replicate_state(state, group)
    mesh.check_replication_consistency(state.D, group, prefix="D.")
    res["replicated"] = {"D": {k: v.clone() for k, v in state.D.state_dict().items()}, "w_avg": state.w_avg.clone(),
                         "moments": [v.clone() for opt in (state.g_opt, state.d_opt) for per in opt.state.values()
                                     for v in per.values()]}
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def cli_train_rank(rank: int, world: int, rdzv: str, argv, out: str) -> None:
    """`cli.train.main(argv)` as rank `rank` of a torchrun-like environment;
    its final state's tensors and the returned run dir go to `out`/rank<rank>.pt
    (a failure's traceback to `out`/rank<rank>.err)."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    try:
        from pasta_gan_tpu_torch.cli import train as cli_train

        res = cli_train.main([*argv, "--dist_backend", "gloo", "--dist_init", f"file://{rdzv}"])
        state = res["state"]
        torch.save({"run_dir": res["run_dir"], "rank": res["rank"], "world": res["world"], "step": state.step,
                    **{name: getattr(state, name).state_dict() for name in ("G", "D", "G_ema")},
                    "w_avg": state.w_avg}, os.path.join(out, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
