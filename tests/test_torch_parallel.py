"""The port's several-card path (parallel/mesh.py, the rank-strided loader and
the data-parallel trainer) against the JAX package's data mesh, on the CPU.

* The loader: `train/loop.py:batch_indices` for (rank, world) equals JAX
  `InfiniteLoader._batch_indices` at world 1, 2 and 4, and the ranks'
  batches partition the global batch (as tests/test_multihost.py:35 holds
  for JAX); at world 1 the indices are the stream positions of before.
* One job of two gloo ranks, spawned (tests/_torch_dist.py:mesh_rank, a
  `file://` rendezvous in tmp_path), against JAX on 2 of the 8 virtual CPU
  devices (tests/conftest.py):
  - the reduce: `all_reduce_mean` of a small D's gradients, each rank on its
    half of the batch, equals `shard_map` + `lax.pmean` within rtol 1e-4,
    atol 1e-6 (tests/test_train.py:189);
  - the step: one `train_step`, then one `d_r1_step`, at the tiny config of
    tests/test_torch_train.py (noise off, z_dim 0, ADA off: no rank draws
    anything, so no draws are passed in), each rank on its contiguous half
    of the batch as `PartitionSpec("data")` gives it, against
    `make_sharded_train_step` over a 2-device mesh from the same weights,
    within tests/test_torch_train.py's tolerances; both ranks' G, D and
    G_ema bitwise equal after each step;
  - Greg: one `g_pl_step` at `pl_weight` 2 from pl_mean 0.05, each rank
    given the path-length noise of JAX's device of its index (the key
    folded with the device index, then the step), against JAX's
    `g_pl_step` over the mesh: the stats and the new pl_mean within
    LOSS_RTOL, G's step within STEP_REL_L2; both ranks' pl_mean and G
    bitwise equal (the three all-reduces of the step);
  - the check: `check_replication_consistency` passes on the replicas, and
    with one leaf of rank 1's D moved it raises on both ranks, naming that
    leaf in JAX's words; `train/loop.py:replicate_state` then gives rank 1
    rank 0's D, w_avg and Adam moments again.
* `rank_seed`, `shard_batch` and the identities at world 1.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from pasta_gan_tpu.models import Discriminator as JaxDiscriminator
from pasta_gan_tpu.parallel.mesh import (
    DATA_AXIS,
    data_parallel_mesh,
    make_sharded_train_step,
    replicate,
    shard_batch as jax_shard_batch,
)
from pasta_gan_tpu.train.loop import InfiniteLoader as JaxInfiniteLoader
from pasta_gan_tpu.train.step import GANTrainer as JaxGANTrainer
from pasta_gan_tpu_torch.io.from_jax import discriminator_state_dict_from_jax, state_dict_from_jax
from pasta_gan_tpu_torch.nn.discriminator import Discriminator
from pasta_gan_tpu_torch.parallel import mesh
from pasta_gan_tpu_torch.train.loop import batch_indices

import _torch_dist
from test_torch_discriminator import CFG as SMALL_CFG
from test_torch_train import (N, RES, LOSS_RTOL, STEP_REL_L2, _flat, draw_variables, jax_tiny_config, make_pair,
                              numpy_batch, port_config, rel_l2)
from test_torch_train_loop import one_torch_thread  # noqa: F401  (autouse fixture)

PERTURB = "b8.conv0.weight"
PL_MEAN = 0.05


def _jax_indices(n, per_rank, seed, b, rank, world):
    loader = object.__new__(JaxInfiniteLoader)  # the index rule alone, without its decode threads
    loader.dataset, loader.batch_size, loader.seed, loader.rank, loader.world = range(n), per_rank, seed, rank, world
    return loader._batch_indices(b)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_loader_indices_equal_jax_and_partition_the_global_batch(world):
    n, global_batch, seed = 23, 8, 7  # batches cross epoch boundaries
    per_rank = global_batch // world
    for b in range(7):
        ranks = [batch_indices(n, per_rank, seed, b, r, world) for r in range(world)]
        for r, idx in enumerate(ranks):
            assert idx == _jax_indices(n, per_rank, seed, b, r, world), (b, r)
        positions = sorted(b * global_batch + j * world + r for r in range(world) for j in range(per_rank))
        assert positions == list(range(b * global_batch, (b + 1) * global_batch))
        assert sorted(sum(ranks, [])) == sorted(batch_indices(n, global_batch, seed, b))
    assert batch_indices(n, 8, seed, 3) == [int(np.random.default_rng((seed, pos // n)).permutation(n)[pos % n])
                                           for pos in range(24, 32)]


def test_world_one_identities_and_helpers():
    t = [torch.ones(3), torch.zeros(2, 2)]
    assert mesh.all_reduce_mean(t, None) == t and torch.equal(t[0], torch.ones(3))
    mesh.replicate_tensors(t, group=None)
    mesh.check_replication_consistency(torch.nn.Linear(2, 2), None)
    assert mesh.initialize_distributed("gloo", world_size=1) is None
    assert (mesh.world(), mesh.rank()) == (1, 0)
    seeds = {mesh.rank_seed(0, r) for r in range(4)} | {mesh.rank_seed(1, 0)}
    assert len(seeds) == 5
    batch = {"a": np.arange(8), "b": torch.arange(16).reshape(8, 2)}
    np.testing.assert_array_equal(mesh.shard_batch(batch, 1, 4)["a"], [2, 3])
    assert mesh.shard_batch(batch, 3, 4)["b"].tolist() == [[12, 13], [14, 15]]
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_batch(batch, 0, 3)
    with pytest.raises(ValueError, match="backend"):
        mesh.initialize_distributed("mpi", world_size=2, rank=0)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Both ranks' results of tests/_torch_dist.py:mesh_rank and the JAX side's."""
    tmp = tmp_path_factory.mktemp("mesh")
    jt, js, pt, ps, _, _ = make_pair(jax_tiny_config())
    b_np = numpy_batch()
    rng = np.random.default_rng(5)
    img = (rng.standard_normal((4, 32, 32, 3)) * 0.5).astype(np.float32)
    c = rng.standard_normal((4, 512)).astype(np.float32)
    jd = JaxDiscriminator(**SMALL_CFG)
    d_vars = draw_variables(jax.eval_shape(jd.init, jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(c)), 4)
    small = Discriminator(**SMALL_CFG)
    small_sd = discriminator_state_dict_from_jax(d_vars, small.state_dict())
    assert PERTURB in dict(ps.D.named_parameters())
    jcfg_pl = dataclasses.replace(jt.config, loss=dataclasses.replace(jt.config.loss, pl_weight=2.0))
    pl_rng = jax.random.PRNGKey(3)
    pl_shape = (max(1, N // _torch_dist.WORLD // jcfg_pl.loss.pl_batch_shrink), RES, RES, 3)
    pl_noise = [np.array(jax.random.normal(jax.random.split(jax.random.fold_in(jax.random.fold_in(pl_rng, r), js.step),
                                                             2)[0], pl_shape) / jnp.sqrt(jnp.float32(RES * RES)))
                for r in range(_torch_dist.WORLD)]  # pasta_gan_tpu/train/step.py:510-512, :551-553
    js_pl = dataclasses.replace(jax.tree_util.tree_map(np.array, js), pl_mean=np.float32(PL_MEAN))
    torch.save({"small_cfg": SMALL_CFG, "small_sd": small_sd, "small_img": img, "small_c": c,
                "vgg_sd": pt.vgg.state_dict(), "config": pt.config, "G": ps.G.state_dict(), "D": ps.D.state_dict(),
                "batch": {k: v.astype(np.int64) if k == "gt_parsing" else v for k, v in b_np.items()},
                "perturb": PERTURB, "config_pl": port_config(jcfg_pl), "pl_mean": PL_MEAN, "pl_noise": pl_noise},
               tmp / "inputs.pt")
    ctx = _torch_dist.spawn_ranks(_torch_dist.mesh_rank, str(tmp / "rdzv"), str(tmp / "inputs.pt"), str(tmp))

    # the JAX side meanwhile, on 2 of the 8 virtual devices
    m = data_parallel_mesh(jax.devices()[:2])

    def pmean_grads(params, x, cc):
        loss = lambda p: jnp.mean(jax.nn.softplus(jd.apply(p, x, cc)))  # noqa: E731
        return jax.lax.pmean(jax.grad(loss)(params), DATA_AXIS)

    reduce_ref = jax.jit(jax.shard_map(pmean_grads, mesh=m, in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS)),
                                       out_specs=P(), check_vma=False))(d_vars, img, c)
    reduce_ref = discriminator_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, reduce_ref))
    jdp = JaxGANTrainer(jt.config, vgg_params=jt.vgg_params, axis_name=DATA_AXIS)
    batch = jax_shard_batch(b_np, m)
    jdp_pl = JaxGANTrainer(jcfg_pl, vgg_params=jt.vgg_params, axis_name=DATA_AXIS)
    jg, jgstats = make_sharded_train_step(jdp_pl.g_pl_step, m)(replicate(js_pl, m), batch, pl_rng)
    greg_ref = {"G": jax.tree_util.tree_map(np.asarray, jg.g_params), "pl_mean": float(jg.pl_mean),
                "stats": {k: float(v) for k, v in jgstats.items()}}
    js1, jstats = make_sharded_train_step(jdp.train_step, m)(replicate(js, m), batch, jax.random.PRNGKey(1))
    step_ref = jax.tree_util.tree_map(np.asarray, (js1.g_params, js1.d_params, js1.g_ema_params, js1.w_avg,
                                                   js1.ada_signs_sum, js1.ada_signs_count))
    jstats = {k: float(v) for k, v in jstats.items()}
    js2, jr1 = make_sharded_train_step(jdp.d_r1_step, m)(js1, batch, jax.random.PRNGKey(2))
    r1_ref = jax.tree_util.tree_map(np.asarray, js2.d_params)
    jr1 = {k: float(v) for k, v in jr1.items()}

    _torch_dist.join(ctx)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(_torch_dist.WORLD)]
    before = {"G": ps.G.state_dict(), "D": ps.D.state_dict()}
    return dict(ranks=ranks, reduce_ref=reduce_ref, step_ref=step_ref, jstats=jstats, r1_ref=r1_ref, jr1=jr1,
                greg_ref=greg_ref, before=before)


def test_all_reduce_mean_equals_jax_pmean(job):
    ref = job["reduce_ref"]
    for res in job["ranks"]:
        assert sorted(res["reduce"]) == sorted(ref)
        for name, g in res["reduce"].items():
            np.testing.assert_allclose(g.numpy(), ref[name].numpy(), rtol=1e-4, atol=1e-6, err_msg=name)
    assert any(float(v.abs().max()) > 0 for v in job["ranks"][0]["reduce"].values())


def _step_err(after, before, ref):
    delta = lambda sd: {k: sd[k].numpy() - before[k].numpy() for k in ref}  # noqa: E731
    return rel_l2(_flat(delta(after)), _flat(delta(ref)))


def test_two_rank_steps_equal_the_jax_mesh_and_stay_replicated(job):
    g_ref, d_ref, ema_ref, w_avg, signs_sum, signs_count = job["step_ref"]
    g_ref, ema_ref = state_dict_from_jax(g_ref), state_dict_from_jax(ema_ref)
    d_ref = discriminator_state_dict_from_jax(d_ref)
    r1_ref = discriminator_state_dict_from_jax(job["r1_ref"])
    before = job["before"]
    for res in job["ranks"]:
        assert sorted(res["step_stats"]) == sorted(job["jstats"])
        for k, v in job["jstats"].items():
            np.testing.assert_allclose(res["step_stats"][k], v, rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
        assert _step_err(res["step"]["G"], before["G"], g_ref) <= STEP_REL_L2
        assert _step_err(res["step"]["D"], before["D"], d_ref) <= STEP_REL_L2
        assert _step_err(res["step"]["G_ema"], before["G"], ema_ref) <= STEP_REL_L2
        assert rel_l2(res["w_avg"].numpy(), w_avg) <= 1e-4
        np.testing.assert_allclose(res["signs"][0], float(signs_sum), atol=1e-6)
        assert res["signs"][1] == float(signs_count) == 1.0
        for k in ("Loss/r1_penalty", "Loss/D/reg"):
            np.testing.assert_allclose(res["r1_stats"][k], job["jr1"][k], rtol=LOSS_RTOL, err_msg=k)
        assert _step_err(res["r1"]["D"], res["step"]["D"], r1_ref) <= STEP_REL_L2
    a, b = job["ranks"]
    for phase, names in (("step", ("G", "D", "G_ema")), ("r1", ("G", "D"))):
        for name in names:
            for k, v in a[phase][name].items():
                assert torch.equal(v, b[phase][name][k]), (phase, name, k)


def test_two_rank_greg_equals_the_jax_mesh_and_stays_replicated(job):
    ref = job["greg_ref"]
    g_ref = state_dict_from_jax(ref["G"])
    for res in job["ranks"]:
        assert sorted(res["greg_stats"]) == sorted(ref["stats"])
        for k, v in ref["stats"].items():
            np.testing.assert_allclose(res["greg_stats"][k], v, rtol=LOSS_RTOL, err_msg=k)
        assert res["greg_stats"]["Loss/pl_penalty"] > 0
        np.testing.assert_allclose(float(res["pl_mean"]), ref["pl_mean"], rtol=LOSS_RTOL)
        assert float(res["pl_mean"]) != PL_MEAN
        assert _step_err(res["greg"], job["before"]["G"], g_ref) <= STEP_REL_L2
    a, b = job["ranks"]
    assert torch.equal(a["pl_mean"], b["pl_mean"])
    for k, v in a["greg"].items():
        assert torch.equal(v, b["greg"][k]), k


def test_check_replication_consistency_names_the_leaf(job):
    for res in job["ranks"]:
        assert res["perturbed"] == f"replication mismatch at D.{PERTURB}: device 0 vs device 1"


def test_replicate_state_restores_rank_0s_state(job):
    a, b = (res["replicated"] for res in job["ranks"])
    assert a["D"].keys() == b["D"].keys() and all(torch.equal(v, b["D"][k]) for k, v in a["D"].items())
    assert torch.equal(a["w_avg"], b["w_avg"])
    assert len(a["moments"]) == len(b["moments"]) > 0
    assert all(torch.equal(x, y) for x, y in zip(a["moments"], b["moments"]))
