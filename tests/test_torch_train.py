"""The port's training path (pasta_gan_tpu_torch/train, nn/discriminator.py)
against the JAX package's `GANTrainer`, on the CPU, at the tiny config of
tests/test_train.py (res 16, channel_base 256, channel_max 32, mbstd group 2).

Same weights on both sides (JAX variables drawn from a numpy seed, carried
across by io/from_jax.py), same batch, noise off, ADA off, VGG on with
carried weights, fp32:

* one Gmain and one Dmain gradient: every parameter's gradient within a
  relative L2 error of 1e-3, or, for the gradients that are 0 in exact
  arithmetic (the biases in front of an InstanceNorm), within 1e-6 of the
  network's largest gradient norm;
* one `train_step` and one `d_r1_step`: every loss within relative 1e-4;
  the updated parameters' steps (all of G's, all of D's, flattened) and
  G_ema's within a relative L2 of 1e-2, w_avg within 1e-4.  Both sides run
  Adam with eps 1e-3 here: with the preset's 1e-8, the first step is
  ~lr sign(g) even for gradients that are rounding noise (the biases in
  front of an InstanceNorm), which then differ at random.  The 1e-2 leaves
  room for Adam's normalization of the gradients' 1e-3 differences and for
  Dmain running on the G that Gmain updated.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pasta_gan_tpu.runtime import config as jconfig
from pasta_gan_tpu.train.state import TrainState as JaxTrainState
from pasta_gan_tpu.train.step import GANTrainer as JaxGANTrainer
from pasta_gan_tpu.train.vgg import init_vgg19 as jax_init_vgg19
from pasta_gan_tpu_torch.io.from_jax import (
    discriminator_state_dict_from_jax,
    state_dict_from_jax,
    vgg19_state_dict_from_jax,
)
from pasta_gan_tpu_torch.runtime import config as tconfig
from pasta_gan_tpu_torch.train.step import GANTrainer
from pasta_gan_tpu_torch.train.vgg import VGG19Features

from test_torch_train_loop import one_torch_thread  # noqa: F401  (autouse fixture)

N, RES = 4, 16
LOSS_RTOL = 1e-4
GRAD_REL_L2 = 1e-3
STEP_REL_L2 = 1e-2


def jax_tiny_config():
    return jconfig.TrainConfig(
        model=jconfig.ModelConfig(img_resolution=RES, channel_base=256, channel_max=32, mbstd_group_size=2,
                                  mapping_layers=1, use_noise=False),
        loss=jconfig.LossConfig(l1_weight=40.0, vgg_weight=40.0, mask_weight=20.0, r1_gamma=10.0),
        ada=jconfig.AdaConfig(enabled=False),
        # Adam's eps at 1e-3 (both sides): entries whose gradient is rounding
        # noise take a step ~lr * g / eps, not the ~lr sign(g) that would
        # differ between the two frameworks at random
        g_opt=jconfig.OptimizerConfig(lr=0.002, eps=1e-3),
        d_opt=jconfig.OptimizerConfig(lr=0.002, eps=1e-3),
        batch_size=N,
        ema_kimg=0.01,  # a visible G_ema step (beta 0.5 ** 0.4)
    )


def port_config(jcfg):
    return tconfig.from_dict(dataclasses.asdict(jcfg))


def numpy_batch(seed=0, n=N, res=RES):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal((n,) + s).astype(np.float32)  # noqa: E731
    return {
        "real_img": np.clip(f(res, res, 3) * 0.5, -1, 1), "style_input": f(res, res, 42),
        "retain": f(res, res, 3), "pose": f(res, res, 6),
        "denorm_upper_img": f(res, res, 3), "denorm_lower_img": f(res, res, 3),
        "denorm_upper_mask": (rng.uniform(size=(n, res, res, 1)) > 0.5).astype(np.float32),
        "denorm_lower_mask": (rng.uniform(size=(n, res, res, 1)) > 0.5).astype(np.float32),
        "gt_parsing": np.where(rng.uniform(size=(n, res, res)) < 0.1, 255,
                               rng.integers(0, 6, (n, res, res))).astype(np.int32),
    }


def draw_variables(shapes, seed):
    """Every leaf of a JAX variable tree drawn from a numpy seed, scaled as
    the layer's init would (equalized-lr weights N(0,1), mapping FCs over
    their lr multiplier, flax kernels over sqrt(fan_in), small biases)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        names = [p.key for p in path]
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if names[-1] in ("bias", "m_bias1", "noise_strength"):
            x = x * 0.1 + (1.0 if names[-2] == "affine" else 0.0)
        elif names[-1] == "kernel":
            x = x / np.sqrt(np.prod(leaf.shape[:-1]))
        elif "mapping" in names and names[-2].startswith("fc"):
            x = x / 0.01
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def pair():
    """(JAX trainer, JAX state, port trainer, port state, batch) on the same weights."""
    return make_pair(jax_tiny_config())


def make_pair(jcfg):
    """`pair` for the JAX config `jcfg` (the port's config translated from it);
    without a VGG when `jcfg.loss.vgg_weight` is 0."""
    with_vgg = jcfg.loss.vgg_weight > 0
    vgg_vars = jax.tree_util.tree_map(np.asarray, jax_init_vgg19(jax.random.PRNGKey(3), image_size=16)) \
        if with_vgg else None
    jt = JaxGANTrainer(jcfg, vgg_params=vgg_vars)
    b_np = numpy_batch()
    b_j = {k: jnp.asarray(v) for k, v in b_np.items()}
    shapes = jax.eval_shape(jt.init_state, jax.random.PRNGKey(0), b_j)
    g_vars = draw_variables(shapes.g_params, 1)
    d_vars = draw_variables(shapes.d_params, 2)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), g_params=g_vars, d_params=d_vars,
        g_ema_params=jax.tree_util.tree_map(np.copy, g_vars), w_avg=jnp.zeros((512,), jnp.float32),
        g_opt_state=jt.g_tx.init(g_vars), d_opt_state=jt.d_tx.init(d_vars), pl_mean=jnp.zeros(()),
        ada_p=jnp.zeros(()), ada_signs_sum=jnp.zeros(()), ada_signs_count=jnp.zeros(()),
    )

    vgg = None
    if with_vgg:
        vgg = VGG19Features()
        vgg.load_state_dict(vgg19_state_dict_from_jax(vgg_vars, vgg.state_dict()), strict=True)
        vgg = vgg.requires_grad_(False).eval()
    pt = GANTrainer(port_config(jcfg), vgg=vgg, device="cpu")
    G, D = pt.build_networks()
    G.load_state_dict(state_dict_from_jax(g_vars, G.state_dict()), strict=True)
    D.load_state_dict(discriminator_state_dict_from_jax(d_vars, D.state_dict()), strict=True)
    pstate = pt.init_state(G=G, D=D)
    b_t = {k: torch.from_numpy(v.astype(np.int64) if k == "gt_parsing" else v) for k, v in b_np.items()}
    return jt, jstate, pt, pstate, b_j, b_t


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    nb = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / nb) if nb > 0 else float(np.linalg.norm(a))


def _flat(sd):
    return np.concatenate([np.asarray(v, np.float64).ravel() for _, v in sorted(sd.items())])


def test_gmain_and_dmain_gradients_match_jax(pair):
    jt, js, pt, ps, b_j, b_t = pair
    key = jax.random.PRNGKey(1)

    @jax.jit
    def jax_grads(g, d):
        gg = jax.grad(lambda p: jt.g_loss_fn(p, d, b_j, js.ada_p, key)[0])(g)
        dg = jax.grad(lambda p: jt.d_loss_fn(p, g, b_j, js.ada_p, key)[0])(d)
        return gg, dg

    g_ref, d_ref = jax_grads(js.g_params, js.d_params)
    g_ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, g_ref))
    d_ref = discriminator_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, d_ref))

    g_names = [n for n, _ in ps.G.named_parameters()]
    g_ours, _ = pt._grads_with_accum(lambda b: pt.g_loss_fn(ps.G, ps.D, b), list(ps.G.parameters()), b_t)
    d_names = [n for n, _ in ps.D.named_parameters()]
    d_ours, _ = pt._grads_with_accum(lambda b: pt.d_loss_fn(ps.D, ps.G, b), list(ps.D.parameters()), b_t)
    assert sorted(g_names) == sorted(g_ref) and sorted(d_names) == sorted(d_ref)
    bad = {}
    for names, ours, ref in ((g_names, g_ours, g_ref), (d_names, d_ours, d_ref)):
        floor = 1e-6 * max(float(np.linalg.norm(v.numpy())) for v in ref.values())
        for n, g in zip(names, ours):
            err = float(np.linalg.norm(g.numpy() - ref[n].numpy()))
            if err > GRAD_REL_L2 * float(np.linalg.norm(ref[n].numpy())) + floor:
                bad[n] = rel_l2(g.numpy(), ref[n].numpy())
    assert not bad, bad
    assert any(float(np.abs(g_ref[n].numpy()).max()) > 0 for n in g_ref)


def test_train_step_and_r1_step_match_jax(pair):
    jt, js, pt, ps, b_j, b_t = pair
    ps = copy.deepcopy(ps)  # the steps update in place
    g0 = {k: v.clone() for k, v in ps.G.state_dict().items()}
    d0 = {k: v.clone() for k, v in ps.D.state_dict().items()}

    js1, jstats = jax.jit(jt.train_step)(js, b_j, jax.random.PRNGKey(1))
    ps1, stats = pt.train_step(ps, b_t)
    assert sorted(stats) == sorted(jstats)
    for k, v in jstats.items():
        np.testing.assert_allclose(float(stats[k]), float(v), rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    assert ps1.step == 1

    def step_err(module, before, jax_params, translate):
        ref = translate(jax.tree_util.tree_map(np.asarray, jax_params))
        ours = module.state_dict()
        delta_ours = {k: ours[k].numpy() - before[k].numpy() for k in ref}
        delta_ref = {k: ref[k].numpy() - before[k].numpy() for k in ref}
        return rel_l2(_flat(delta_ours), _flat(delta_ref))

    assert step_err(ps1.G, g0, js1.g_params, state_dict_from_jax) <= STEP_REL_L2
    assert step_err(ps1.D, d0, js1.d_params, discriminator_state_dict_from_jax) <= STEP_REL_L2
    assert step_err(ps1.G_ema, g0, js1.g_ema_params, state_dict_from_jax) <= STEP_REL_L2
    assert rel_l2(ps1.w_avg.numpy(), np.asarray(js1.w_avg)) <= 1e-4
    assert float(ps1.ada_signs_count) == float(js1.ada_signs_count) == 1.0
    np.testing.assert_allclose(float(ps1.ada_signs_sum), float(js1.ada_signs_sum), atol=1e-6)

    # R1 from the updated state, on both sides
    d1 = {k: v.clone() for k, v in ps1.D.state_dict().items()}
    js2, jr1 = jax.jit(jt.d_r1_step)(js1, b_j, jax.random.PRNGKey(2))
    ps2, r1 = pt.d_r1_step(ps1, b_t)
    for k in ("Loss/r1_penalty", "Loss/D/reg"):
        np.testing.assert_allclose(float(r1[k]), float(jr1[k]), rtol=LOSS_RTOL, err_msg=k)
    assert float(r1["Loss/r1_penalty"]) > 0
    assert step_err(ps2.D, d1, js2.d_params, discriminator_state_dict_from_jax) <= STEP_REL_L2
    for k in g0:  # R1 leaves G alone
        torch.testing.assert_close(ps2.G.state_dict()[k], ps1.G.state_dict()[k], rtol=0, atol=0)


def test_lazy_reg_optimizer_settings_match_jax(pair):
    jt, _, pt, ps, _, _ = pair
    for group, cfg in ((ps.g_opt.param_groups[0], jconfig.lazy_reg_scaling(jt.config.g_opt, 4)),
                       (ps.d_opt.param_groups[0], jconfig.lazy_reg_scaling(jt.config.d_opt, 16))):
        assert group["lr"] == pytest.approx(cfg.lr) and group["eps"] == cfg.eps
        assert group["betas"] == pytest.approx((cfg.beta1, cfg.beta2))
    assert isinstance(jt.g_tx, optax.GradientTransformation)
