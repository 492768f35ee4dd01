"""The int8 serving forwards of GeneratorFull, GeneratorV18 and Generator512
(thin: channel_base 512, channel_max 32, 64px, batch 1) against the JAX
package's, `pack_tail=False` (the path without W-packing, which the port
follows).

A generator's int8 forward is not continuous: a float difference of one ulp
before a quantize can flip a rounding, which moves the next layers' inputs by
one int8 step and flips more roundings downstream (and, through the parsing
argmax or the mask threshold, the SPADE masks).  So the JAX forward itself
moves when its inputs move by PERTURB relative, about as far as the port's
float ops differ from JAX's, and nearly as far as int8 is from fp32.  Each
test measures that sensitivity, the largest of five moves of JAX's own
forward (int8 and int8_static each on two input draws, and int8_static on
scales calibrated from perturbed batches: one draw is as random as the
port's own distance, and the three modes share the rounding dynamics), and
holds the port within SENSITIVITY_FACTOR times it (a limit at 1/10 of
JAX's int8-vs-fp32 distance would not hold for JAX against itself).  The
same convs must run int8 on both sides (counted by class), and the sites
whose input is computed in float alone must calibrate to JAX's amax within
CALIB_REL.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pasta_gan_tpu.cli.test import calibrate_int8_static as jax_calibrate
from pasta_gan_tpu.models import Generator512 as JaxGenerator512
from pasta_gan_tpu.models import GeneratorFull as JaxGeneratorFull
from pasta_gan_tpu.models import GeneratorV18 as JaxGeneratorV18
from pasta_gan_tpu.ops import quant as jq
from pasta_gan_tpu_torch.cli import test as cli
from pasta_gan_tpu_torch.io.from_jax import quant_scales_from_jax, state_dict_from_jax
from pasta_gan_tpu_torch.models import Generator512, GeneratorFull, GeneratorV18
from pasta_gan_tpu_torch.ops import quant as tq

from test_torch_generator import KEYS, _inputs, _jax_variables
from test_torch_quant import CALIB_REL, _rel_l2

PERTURB = 1e-6
SENSITIVITY_FACTOR = 2.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread while this module runs: the test workers
    share the machine's cores, and oversubscribed OpenMP threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GENERATORS = {  # name: (JAX class, port class, style channels, img_resolution)
    "full": (JaxGeneratorFull, GeneratorFull, 42, 64),
    "v18": (JaxGeneratorV18, GeneratorV18, 60, 64),
    "512": (JaxGenerator512, Generator512, 45, 64),
}


def _gen_inputs(name, seed, N=1):
    _, _, nc, R = GENERATORS[name]
    inp = _inputs(seed=seed, N=N, R=R)
    inp["c"] = np.random.default_rng(seed + 100).standard_normal((N, R // 4, R // 4, nc)).astype(np.float32) * 0.5
    return inp


def _perturbed(inp, seed):
    rng = np.random.default_rng(seed)
    return {k: a if "mask" in k else (a * (1 + PERTURB * rng.standard_normal(a.shape))).astype(np.float32)
            for k, a in inp.items()}


def _cli_batch(inp):
    return dict(style_input=inp["c"], retain=inp["retain"], pose=inp["pose"],
                denorm_upper_img=inp["denorm_upper_input"], denorm_lower_img=inp["denorm_lower_input"],
                denorm_upper_mask=inp["denorm_upper_mask"], denorm_lower_mask=inp["denorm_lower_mask"])


def _count_int8_convs(monkeypatch):
    """Record the class (kh, kw, C, O, stride, dilation) of every int8 conv
    either package runs."""
    convs = {"jax": [], "port": []}
    jax_like, port_conv = jq.int8_conv_like, tq.int8_conv_packed

    def jax_spy(x, w, *, window_strides=(1, 1), lhs_dilation=None, **kw):
        convs["jax"].append(tuple(w.shape) + (window_strides[0], (lhs_dilation or (1, 1))[0]))
        return jax_like(x, w, window_strides=window_strides, lhs_dilation=lhs_dilation, **kw)

    def port_spy(xa, pw, out_dtype=torch.bfloat16):
        O, C, kh, kw = pw.wq.shape
        convs["port"].append((kh, kw, C, O, pw.stride, pw.dilation))
        return port_conv(xa, pw, out_dtype)

    monkeypatch.setattr(jq, "int8_conv_like", jax_spy)
    monkeypatch.setattr(tq, "int8_conv_packed", port_spy)
    return convs


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_int8_matches_jax(name, monkeypatch):
    """The thin generator (batch 1) under "int8", under "int8_static" on
    JAX's calibrated scales and under "int8_static" on the port's own
    calibration (two batches, `cli.test.calibrate_int8_static` against the
    JAX CLI's): the same convs run int8 on both sides, and each output lies
    within SENSITIVITY_FACTOR times JAX's own sensitivity of JAX's output.
    The port's own calibration is held to JAX's static forward on scales
    JAX calibrated from perturbed batches, since calibration moves too.  The
    calibrated scales equal JAX's where the site's input is computed in
    float alone (the first convs of the encoders), and every site lies within
    SENSITIVITY_FACTOR times the spread of JAX's calibration on perturbed
    batches.  Prints each distance beside JAX's int8-vs-fp32 distance, and
    for "full" the pack_tail=True gap."""
    jcls, pcls, _, R = GENERATORS[name]
    cfg = dict(img_resolution=R, channel_base=512, channel_max=32)
    inp = _gen_inputs(name, seed=1)
    calib = [_gen_inputs(name, seed=s) for s in (21, 22)]
    v = _jax_variables(jcls(pack_tail=False, **cfg), inp, seed=2)
    convs = _count_int8_convs(monkeypatch)

    def jax_fwd(quant, pack_tail=False):
        g = jcls(pack_tail=pack_tail, quant=quant, **cfg)
        f = jax.jit(lambda v, x: g.apply(v, None, **x, noise_mode="none"))
        return lambda v, x: [np.asarray(o) for o in jax.tree_util.tree_leaves(
            f(v, {k: jnp.asarray(a) for k, a in x.items()}))]

    def jax_scales(batches):
        ctor = lambda **kw: jcls(pack_tail=False, **cfg, **kw)  # noqa: E731
        cb = [{k: jnp.asarray(a) for k, a in _cli_batch(b).items()} for b in batches]
        return jax_calibrate(ctor, v, jnp.zeros(512), 1.0, cb)["quant_scales"]

    f32, i8, st = jax_fwd(None), jax_fwd("int8"), jax_fwd("int8_static")
    ref32, ref8 = f32(v, inp), i8(v, inp)
    jax_convs = list(convs["jax"])  # traced once, by the int8 forward
    qs = jax_scales(calib)
    ref_st = st({**v, "quant_scales": qs}, inp)
    pert = [_perturbed(inp, s) for s in (31, 32)]
    sens8 = max(max(_rel_l2(a, b) for a, b in zip(i8(v, p), ref8)) for p in pert)
    sens_st = max(max(_rel_l2(a, b) for a, b in zip(st({**v, "quant_scales": qs}, p), ref_st)) for p in pert)
    jax_dist = max(_rel_l2(a, b) for a, b in zip(ref8, ref32))

    port = pcls(**cfg)
    port.load_state_dict(state_dict_from_jax(v, port.state_dict()), strict=True)
    port.eval()
    x = [torch.from_numpy(inp[k]) for k in KEYS]

    def port_fwd():
        with torch.no_grad():
            return [t.numpy() for t in jax.tree_util.tree_leaves(port(None, *x, noise_mode="none"))]

    port.quant = "int8"
    out8 = port_fwd()
    assert sorted(convs["port"]) == sorted(jax_convs), "the two packages run int8 at different convs"
    port.load_quant_scales(quant_scales_from_jax(qs))
    port.quant = "int8_static"
    out_st = port_fwd()
    cli.calibrate_int8_static(port, torch.zeros(512), [{k: torch.from_numpy(a) for k, a in _cli_batch(b).items()}
                                                       for b in calib])
    assert port.quant == "int8_static"
    out_cal = port_fwd()

    want, mine = quant_scales_from_jax(qs), port.quant_scales()
    assert sorted(mine) == sorted(want)
    rel = {k: abs(float(mine[k]) - float(s)) / float(s) for k, s in want.items()}
    float_sites = ["const_encoding.model.0.act_amax", "style_encoding.feat_enc.0.act_amax",
                   "style_encoding.model.2.act_amax"]
    for k in float_sites:
        assert rel[k] <= CALIB_REL, (k, rel[k])
    d8 = max(_rel_l2(a, b) for a, b in zip(out8, ref8))
    d_st = max(_rel_l2(a, b) for a, b in zip(out_st, ref_st))
    d_cal = max(_rel_l2(a, b) for a, b in zip(out_cal, ref_st))
    # JAX calibrated on perturbed batches, then serving perturbed inputs: how far calibration moves JAX itself
    qs_p = jax_scales([_perturbed(b, 33) for b in calib])
    perturbed = quant_scales_from_jax(qs_p)
    rel_jax = max(abs(float(perturbed[k]) - float(s)) / float(s) for k, s in want.items())
    sens_cal = max(_rel_l2(a, b) for a, b in zip(st({**v, "quant_scales": qs_p}, pert[1]), ref_st))
    line = (f"{name}: JAX int8 vs fp32 {jax_dist:.4g}; port vs JAX: int8 {d8:.4g} (JAX sensitivity {sens8:.4g}), "
            f"int8_static on JAX's scales {d_st:.4g} (JAX sensitivity {sens_st:.4g}), on the port's calibration "
            f"{d_cal:.4g} (JAX on its own perturbed calibration {sens_cal:.4g}); calibrated amax max rel "
            f"{max(rel.values()):.3g} (JAX on perturbed batches {rel_jax:.3g}); {len(jax_convs)} int8 convs")
    if name == "full":
        pack_gap = max(_rel_l2(a, b) for a, b in zip(jax_fwd("int8", pack_tail=True)(v, inp), ref8))
        line += f"; JAX pack_tail=True vs False int8 gap {pack_gap:.4g}"
    print(line)
    assert max(rel.values()) <= SENSITIVITY_FACTOR * rel_jax + CALIB_REL
    # one yardstick: the largest of JAX's five measured moves (the modes share the rounding dynamics)
    sens = max(sens8, sens_st, sens_cal)
    for label, d in (("int8", d8), ("int8_static on JAX's scales", d_st), ("int8_static calibrated", d_cal)):
        assert d <= SENSITIVITY_FACTOR * sens, (label, d, sens)
