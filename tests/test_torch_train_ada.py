"""ADA in the port's training step (train/step.py) against the JAX package's
`GANTrainer`, on the CPU, at the tiny config of tests/test_torch_train.py
(res 16, channel_base 256, channel_max 32, mbstd group 2, batch 4, fp32,
noise off, VGG carried, Adam eps 1e-3 on both sides).

Both trainers get the same debug-percentile pipe (`bgc` at percentile 0.3,
every transform applied, no random draw), here with the D calls stacked
and the two-pass warp (tests/test_torch_train_ada_exact.py runs the same
checks with the calls one by one and the exact warp):

* Gmain and Dmain gradients within GRAD_REL_L2 (or 1e-6 of the largest
  gradient norm where the gradient vanishes in exact arithmetic);
* `train_step`: losses within LOSS_RTOL, the G and G_ema steps within
  STEP_REL_L2, and the D step within STEP_REL_L2 of JAX's Dmain (gradient,
  scrub, Adam) taken on the port's updated G.  Dmain runs on the G that
  Gmain updated, and the JAX package's own Dmain step moves by more than
  STEP_REL_L2 when its G update is swapped for the port's (which agrees
  with JAX's within STEP_REL_L2): JAX's Dmain (reproduced here, and held
  to JAX's `train_step` on JAX's G) is taken on the same G as the port's;
* `d_r1_step` (R1 through the pipe) from the same state on both sides:
  losses within LOSS_RTOL, the D step within STEP_REL_L2;
* `_stack_perm` equals JAX's, stacked logits equal one-by-one logits
  within 1e-5, and the p controller fed the same signs for 8 steps gives
  JAX's p within 1e-7.
"""

import copy
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pasta_gan_tpu.runtime import config as jconfig
from pasta_gan_tpu.train.augment import AugmentPipe as JaxAugmentPipe
from pasta_gan_tpu.train.state import TrainState as JaxTrainState
from pasta_gan_tpu.train.step import GANTrainer as JaxGANTrainer
from pasta_gan_tpu.train.vgg import init_vgg19 as jax_init_vgg19
from pasta_gan_tpu_torch.io.from_jax import (
    discriminator_state_dict_from_jax,
    state_dict_from_jax,
    vgg19_state_dict_from_jax,
)
from pasta_gan_tpu_torch.runtime import config as tconfig
from pasta_gan_tpu_torch.train.augment import AugmentPipe
from pasta_gan_tpu_torch.train.step import GANTrainer
from pasta_gan_tpu_torch.train.vgg import VGG19Features

from test_torch_train import (
    GRAD_REL_L2,
    LOSS_RTOL,
    STEP_REL_L2,
    _flat,
    draw_variables,
    jax_tiny_config,
    numpy_batch,
    port_config,
    rel_l2,
)
from test_torch_train_loop import one_torch_thread  # noqa: F401  (autouse fixture)

DP = 0.3
MODES = {"stacked": dict(stack_calls=True, fast_geom=True), "one_by_one": dict(stack_calls=False, fast_geom=False)}


def make_ada_pair(mode):
    """(JAX trainer, JAX state, port trainer, port state, batches) on the same
    weights, ADA on with the debug-percentile pipe, D calls as MODES[mode]."""
    mode = MODES[mode]
    jcfg = jax_tiny_config()
    jcfg = dataclasses.replace(jcfg, ada=dataclasses.replace(jcfg.ada, enabled=True, initial_p=0.2, **mode))
    jpipe = JaxAugmentPipe.from_spec("bgc", fast_geom=mode["fast_geom"])
    tpipe = AugmentPipe.from_spec("bgc", fast_geom=mode["fast_geom"])
    vgg_vars = jax.tree_util.tree_map(np.asarray, jax_init_vgg19(jax.random.PRNGKey(3), image_size=16))
    jt = JaxGANTrainer(jcfg, vgg_params=vgg_vars,
                       augment_fn=lambda im, p, rng: jpipe(im, p, rng, debug_percentile=DP))
    b_np = numpy_batch()
    b_j = {k: jnp.asarray(v) for k, v in b_np.items()}
    shapes = jax.eval_shape(jt.init_state, jax.random.PRNGKey(0), b_j)
    g_vars = draw_variables(shapes.g_params, 1)
    d_vars = draw_variables(shapes.d_params, 2)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), g_params=g_vars, d_params=d_vars,
        g_ema_params=jax.tree_util.tree_map(np.copy, g_vars), w_avg=jnp.zeros((512,), jnp.float32),
        g_opt_state=jt.g_tx.init(g_vars), d_opt_state=jt.d_tx.init(d_vars), pl_mean=jnp.zeros(()),
        ada_p=jnp.asarray(0.2, jnp.float32), ada_signs_sum=jnp.zeros(()), ada_signs_count=jnp.zeros(()),
    )
    vgg = VGG19Features()
    vgg.load_state_dict(vgg19_state_dict_from_jax(vgg_vars, vgg.state_dict()), strict=True)
    pt = GANTrainer(port_config(jcfg), vgg=vgg.requires_grad_(False).eval(), device="cpu",
                    augment_fn=lambda im, p, gen: tpipe(im, p, gen, debug_percentile=DP))
    G, D = pt.build_networks()
    G.load_state_dict(state_dict_from_jax(g_vars, G.state_dict()), strict=True)
    D.load_state_dict(discriminator_state_dict_from_jax(d_vars, D.state_dict()), strict=True)
    pstate = pt.init_state(G=G, D=D)
    assert float(pstate.ada_p) == pytest.approx(0.2)
    b_t = {k: torch.from_numpy(v.astype(np.int64) if k == "gt_parsing" else v) for k, v in b_np.items()}
    return jt, jstate, pt, pstate, b_j, b_t


@pytest.fixture(scope="module")
def ada_pair():
    return make_ada_pair("stacked")


def test_ada_gmain_and_dmain_gradients_match_jax(ada_pair):
    jt, js, pt, ps, b_j, b_t = ada_pair
    key = jax.random.PRNGKey(1)

    @jax.jit
    def jax_grads(g, d):
        gg = jax.grad(lambda p: jt.g_loss_fn(p, d, b_j, js.ada_p, key)[0])(g)
        dg = jax.grad(lambda p: jt.d_loss_fn(p, g, b_j, js.ada_p, key)[0])(d)
        return gg, dg

    g_ref, d_ref = jax_grads(js.g_params, js.d_params)
    g_ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, g_ref))
    d_ref = discriminator_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, d_ref))
    p = float(ps.ada_p)
    g_names = [n for n, _ in ps.G.named_parameters()]
    g_ours, _ = pt._grads_with_accum(lambda b: pt.g_loss_fn(ps.G, ps.D, b, p), list(ps.G.parameters()), b_t)
    d_names = [n for n, _ in ps.D.named_parameters()]
    d_ours, _ = pt._grads_with_accum(lambda b: pt.d_loss_fn(ps.D, ps.G, b, p), list(ps.D.parameters()), b_t)
    bad = {}
    for names, ours, ref in ((g_names, g_ours, g_ref), (d_names, d_ours, d_ref)):
        floor = 1e-6 * max(float(np.linalg.norm(v.numpy())) for v in ref.values())
        for n, g in zip(names, ours):
            err = float(np.linalg.norm(g.numpy() - ref[n].numpy()))
            if err > GRAD_REL_L2 * float(np.linalg.norm(ref[n].numpy())) + floor:
                bad[n] = rel_l2(g.numpy(), ref[n].numpy())
    assert not bad, bad


def test_ada_train_step_and_r1_step_match_jax(ada_pair):
    jt, js, pt, ps, b_j, b_t = ada_pair
    ps = copy.deepcopy(ps)  # the steps update in place
    g0 = {k: v.clone() for k, v in ps.G.state_dict().items()}
    d0 = {k: v.clone() for k, v in ps.D.state_dict().items()}

    js1, jstats = jax.jit(jt.train_step)(js, b_j, jax.random.PRNGKey(1))
    ps1, stats = pt.train_step(ps, b_t)
    assert sorted(stats) == sorted(jstats)
    for k, v in jstats.items():
        np.testing.assert_allclose(float(stats[k]), float(v), rtol=LOSS_RTOL, atol=1e-6, err_msg=k)

    def step_err(module, before, jax_params, translate):
        ref = translate(jax.tree_util.tree_map(np.asarray, jax_params))
        ours = module.state_dict()
        return rel_l2(_flat({k: ours[k].numpy() - before[k].numpy() for k in ref}),
                      _flat({k: ref[k].numpy() - before[k].numpy() for k in ref}))

    assert step_err(ps1.G, g0, js1.g_params, state_dict_from_jax) <= STEP_REL_L2
    assert step_err(ps1.G_ema, g0, js1.g_ema_params, state_dict_from_jax) <= STEP_REL_L2

    @jax.jit
    def jax_dmain(g_params):  # train_step's Dmain (accum 1) on the given G
        grads = jax.grad(lambda d: jt.d_loss_fn(d, g_params, b_j, js.ada_p, jax.random.PRNGKey(1))[0])(js.d_params)
        grads = jax.tree_util.tree_map(lambda g: jnp.nan_to_num(g, nan=0.0, posinf=1e5, neginf=-1e5), grads)
        updates, _ = jt.d_tx.update(grads, js.d_opt_state, js.d_params)
        return optax.apply_updates(js.d_params, updates)

    def jax_step_err(a, b):
        a, b = (discriminator_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, x)) for x in (a, b))
        return rel_l2(_flat({k: a[k].numpy() - d0[k].numpy() for k in a}),
                      _flat({k: b[k].numpy() - d0[k].numpy() for k in b}))

    assert jax_step_err(jax_dmain(js1.g_params), js1.d_params) <= 1e-4  # the reproduction is train_step's Dmain
    d_ref = jax_dmain(jax_variables(js1.g_params, ps1.G.state_dict()))
    assert step_err(ps1.D, d0, d_ref, discriminator_state_dict_from_jax) <= STEP_REL_L2

    ps = copy.deepcopy(ada_pair[3])
    js2, jr1 = jax.jit(jt.d_r1_step)(js, b_j, jax.random.PRNGKey(2))
    ps2, r1 = pt.d_r1_step(ps, b_t)
    for k in ("Loss/r1_penalty", "Loss/D/reg"):
        np.testing.assert_allclose(float(r1[k]), float(jr1[k]), rtol=LOSS_RTOL, err_msg=k)
    assert float(r1["Loss/r1_penalty"]) > 0
    assert step_err(ps2.D, d0, js2.d_params, discriminator_state_dict_from_jax) <= STEP_REL_L2


def jax_variables(like, state_dict):
    """A port G state_dict as JAX variables shaped like `like`: the inverse of
    `state_dict_from_jax`, read off by translating a tree of element ids."""
    leaves, treedef = jax.tree_util.tree_flatten(like)
    offsets = np.cumsum([0] + [np.size(leaf) for leaf in leaves])
    ids = [np.arange(offsets[i], offsets[i + 1], dtype=np.float64).reshape(np.shape(leaf))
           for i, leaf in enumerate(leaves)]
    flat = np.zeros(offsets[-1], np.float32)
    for k, v in state_dict_from_jax(jax.tree_util.tree_unflatten(treedef, ids)).items():
        flat[v.numpy().astype(np.int64).ravel()] = state_dict[k].numpy().ravel()
    return jax.tree_util.tree_unflatten(
        treedef, [flat[offsets[i]:offsets[i + 1]].reshape(np.shape(leaf)) for i, leaf in enumerate(leaves)])


@pytest.mark.parametrize("group", [None, 2, 4])
def test_stack_perm_matches_jax(group):
    for n in (2, 4, 6, 8):
        for k in (2, 3):
            cfgs = [c.TrainConfig(model=c.ModelConfig(mbstd_group_size=group)) for c in (jconfig, tconfig)]
            ref = JaxGANTrainer._stack_perm(types.SimpleNamespace(config=cfgs[0]), n, k)
            ours = GANTrainer._stack_perm(types.SimpleNamespace(config=cfgs[1]), n, k)
            if ref is None:
                assert ours is None, (n, k)
            else:
                np.testing.assert_array_equal(ours, ref)
                assert sorted(ours) == list(range(n * k))


def test_stacked_logits_equal_one_by_one():
    jcfg = jax_tiny_config()
    cfg = port_config(dataclasses.replace(jcfg, ada=dataclasses.replace(jcfg.ada, enabled=True)))
    pipe = AugmentPipe.from_spec("bgc", fast_geom=True)
    fn = lambda im, p, gen: pipe(im, p, gen, debug_percentile=0.7)  # noqa: E731
    stacked = GANTrainer(cfg, device="cpu", augment_fn=fn)
    one_by_one = GANTrainer(dataclasses.replace(cfg, ada=dataclasses.replace(cfg.ada, stack_calls=False)),
                            device="cpu", augment_fn=fn)
    _, D = stacked.build_networks()
    D.reset_parameters(torch.Generator().manual_seed(0))
    b = numpy_batch(seed=3)
    imgs = [torch.from_numpy(b["real_img"]), torch.from_numpy(b["retain"]).clamp(-1, 1),
            torch.from_numpy(b["denorm_upper_img"]).clamp(-1, 1)]
    c = torch.from_numpy(np.random.default_rng(4).standard_normal((4, 512)).astype(np.float32))
    with torch.no_grad():
        a = stacked._run_D_multi(D, imgs, c, 0.5)
        r = one_by_one._run_D_multi(D, imgs, c, 0.5)
    assert len(a) == len(r) == 3
    for x, y in zip(a, r):
        assert x.shape == (4, 1)
        torch.testing.assert_close(x, y, rtol=0, atol=1e-5)
    # a plain concat would group real and fake samples together and differ
    with torch.no_grad():
        plain = D(torch.cat(imgs).permute(0, 3, 1, 2), torch.cat([c] * 3))
    assert not torch.allclose(plain[:4], r[0], atol=1e-3)


def test_ada_controller_matches_jax():
    """Both `train_step`s with their gradient passes replaced by zero
    gradients and a fed mean sign of D(real): only the bookkeeping runs."""
    signs = [0.9, 0.7, 0.5, 1.0, -0.2, 0.3, 0.65, 0.55]
    jcfg = dataclasses.replace(jax_tiny_config(), batch_size=8,
                               ada=jconfig.AdaConfig(enabled=True, target=0.6, interval=4, kimg=1, initial_p=0.05))
    jt = JaxGANTrainer(jcfg)
    feed = iter(signs)

    def jax_grads(loss_fn, params, batch, rng, *extra):
        zero = jax.tree_util.tree_map(jnp.zeros_like, params)
        if "w" in params:
            return zero, ({"Loss/signs/fake": jnp.zeros(())}, jnp.zeros((512,)))
        return zero, {"Loss/signs/real": jnp.float32(next(feed))}

    jt._grads_with_accum = jax_grads
    tiny = {"w": jnp.zeros((1,))}
    js = JaxTrainState(step=jnp.zeros((), jnp.int32), g_params=tiny, d_params={"v": jnp.zeros((1,))},
                       g_ema_params=tiny, w_avg=jnp.zeros((512,)), g_opt_state=jt.g_tx.init(tiny),
                       d_opt_state=jt.d_tx.init({"v": jnp.zeros((1,))}), pl_mean=jnp.zeros(()),
                       ada_p=jnp.float32(0.05), ada_signs_sum=jnp.zeros(()), ada_signs_count=jnp.zeros(()))
    jp = []
    for _ in signs:
        js, st = jt.train_step(js, {}, jax.random.PRNGKey(0))
        jp.append(float(st["Progress/augment_p"]))

    pt = GANTrainer(port_config(jcfg), device="cpu", augment_fn=lambda im, p, gen: im)
    G, D = torch.nn.Linear(1, 1), torch.nn.Linear(1, 1)
    ps = types.SimpleNamespace(
        step=0, G=G, D=D, G_ema=copy.deepcopy(G), g_opt=torch.optim.Adam(G.parameters()),
        d_opt=torch.optim.Adam(D.parameters()), w_avg=torch.zeros(512), ada_p=torch.tensor(0.05),
        ada_signs_sum=torch.zeros(()), ada_signs_count=torch.zeros(()))
    feed_t = iter(signs)

    def port_grads(loss_fn, params, batch):
        zero = [torch.zeros_like(p) for p in params]
        if params[0] is G.weight:
            return zero, {"w_mean": torch.zeros(512)}
        return zero, {"Loss/signs/real": torch.tensor(next(feed_t), dtype=torch.float32)}

    pt._grads_with_accum = port_grads
    tp = []
    for _ in signs:
        ps, st = pt.train_step(ps, {})
        tp.append(float(st["Progress/augment_p"]))
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-7)
    assert jp[3] != 0.05 and jp[7] != jp[3]  # the controller moved p at steps 4 and 8
    assert float(ps.ada_signs_count) == 0.0
