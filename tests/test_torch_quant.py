"""int8 serving of the port (`ops/quant.py`, the plain version of
`csrc/int8_conv.cu`) against the JAX package's (`pasta_gan_tpu/ops/quant.py`).

* `quantize_weight` / `quantize_act` / `quantize_act_with_scale`: the same
  int8 values and scales, exactly; so is `quantize_pack` (the plain version
  of `csrc/quantize_pack.cu`), unpacked to NCHW, in fp32 and bf16, per
  sample and with a scalar scale, at channel counts that are not a multiple
  of 16 (its pad channels are 0).
* `int8_conv2d`: bit for bit (fp32 and bf16 output) for every conv class the
  three generators give it (1x1, 3x3, 3x3 stride 2, 1x1 stride 2, 7x7 of 3
  channels, the folded 6x6 up-conv with input dilation 2, `flip_weight`
  False), with per-sample and scalar scales; `fold_up_weights` bit for bit.
* The kernel's operands (`kernel_operands`: the NHWC activation, the weight
  packed by phase, the tap table), read in numpy as the kernel reads them,
  give the plain version's accumulator.
* ResBlock (stride 1 and down 2), SpadeResBlock and SynthesisLayer (stride 1
  and the folded up-conv) under "int8" and "int8_static" (JAX's calibrated
  scales) against the JAX modules (`pack_mode` None, the `pack_tail=False`
  path): relative L2 <= MODULE_REL_L2, and the port's own calibration gives
  JAX's amax at every site within 1e-6 relative.
* The state_dict is the same under every mode; the quant_scales collection
  maps site by site; cli.test serves `--quant int8_static`.
* Each conv module's cached int8 weight (`Int8WeightCache`) gives the
  output of a module that builds it anew, bit for bit, and is rebuilt
  after `load_state_dict`, an in-place update and a quant-mode switch.

The generators' int8 forwards against JAX are in test_torch_quant_generators.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pasta_gan_tpu.nn import layers as jl
from pasta_gan_tpu.nn import spade as jsp
from pasta_gan_tpu.nn import synthesis as jsy
from pasta_gan_tpu.ops import quant as jq
from pasta_gan_tpu.ops.packing import fold_up_weights as jax_fold_up_weights
from pasta_gan_tpu_torch.cli import test as cli
from pasta_gan_tpu_torch.io.checkpoints import save_snapshot
from pasta_gan_tpu_torch.io.from_jax import quant_scales_from_jax, state_dict_from_jax
from pasta_gan_tpu_torch.models import Generator512, GeneratorFull, GeneratorV18
from pasta_gan_tpu_torch.nn.layers import ResBlock
from pasta_gan_tpu_torch.nn.spade import SpadeResBlock
from pasta_gan_tpu_torch.nn.synthesis import SynthesisLayer
from pasta_gan_tpu_torch.ops import quant as tq

# Module outputs: both sides quantize bit-identical int8 values here (what is
# left is float ulps, 1e-7); a float op before a quantize that differed by an
# ulp between the frameworks and flipped one rounding (one int8 step, 1/127 of
# the scale, at one element) would give about 1e-4.
MODULE_REL_L2 = 1e-4
CALIB_REL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread while this module runs: the test workers
    share the machine's cores, and oversubscribed OpenMP threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _set_quant(module, mode):
    for m in module.modules():
        if isinstance(m, tq.QuantMode):
            m.quant = mode


# ----------------------------------------------------------------- quantize, conv, fold


def test_quantize_matches_jax_exactly():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((3, 3, 24, 16)) * np.exp(rng.standard_normal(16))).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero output channel: the 1e-12 floor
    jw, jsw = jq.quantize_weight(jnp.asarray(w))
    tw, tsw = tq.quantize_weight(torch.from_numpy(w).permute(3, 2, 0, 1))
    np.testing.assert_array_equal(tw.permute(2, 3, 1, 0).numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tsw.numpy(), np.asarray(jsw))
    x = (rng.standard_normal((4, 6, 5, 8)) * np.array([1.0, 10.0, 1e-3, 0.0])[:, None, None, None]).astype(np.float32)
    jx, jsx = jq.quantize_act(jnp.asarray(x))
    tx, tsx = tq.quantize_act(_nchw(x))
    np.testing.assert_array_equal(_nhwc(tx), np.asarray(jx))
    np.testing.assert_array_equal(tsx.numpy().reshape(-1), np.asarray(jsx).reshape(-1))
    s = np.float32(0.0123)
    jx, _ = jq.quantize_act_with_scale(jnp.asarray(x), jnp.asarray(s))
    tx, _ = tq.quantize_act_with_scale(_nchw(x), torch.tensor(s))
    np.testing.assert_array_equal(_nhwc(tx), np.asarray(jx))


@pytest.mark.parametrize("C", [21, 6, 32])
@pytest.mark.parametrize("scale", ["per_sample", "scalar"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_pack_matches_jax_bit_for_bit(dtype, scale, C):
    rng = np.random.default_rng(C)
    x = (rng.standard_normal((3, 5, 7, C)) * np.array([1.0, 30.0, 1e-3])[:, None, None, None]).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = _nchw(x).to(getattr(torch, dtype))
    if scale == "per_sample":
        ref, jsx = jq.quantize_act(jx)
        xa = tq.quantize_activation(tx)
        np.testing.assert_array_equal(xa.scale.numpy().reshape(-1), np.asarray(jsx).reshape(-1))
    else:
        ref, _ = jq.quantize_act_with_scale(jx, jnp.asarray(np.float32(0.0123)))
        xa = tq.quantize_activation(tx, torch.tensor(np.float32(0.0123)))
    cp = -(-C // 16) * 16
    assert xa.q.dtype == torch.int8 and tuple(xa.q.shape) == (3, 5, 7, cp) and xa.channels == C
    assert xa.q.is_contiguous() and not xa.q[..., C:].any()
    np.testing.assert_array_equal(xa.q[..., :C].numpy(), np.asarray(ref))
    np.testing.assert_array_equal(xa.nchw().permute(0, 2, 3, 1).numpy(), np.asarray(ref))


# (C, O, k, H, W, stride, padding (px0, px1, py0, py1), lhs_dilation, flip_weight)
CONV_CASES = {
    "1x1": (24, 16, 1, 9, 7, 1, (0, 0, 0, 0), 1, True),
    "3x3": (24, 16, 3, 9, 7, 1, (1, 1, 1, 1), 1, True),
    "3x3_stride2": (24, 16, 3, 11, 9, 2, (0, 0, 0, 0), 1, True),
    "1x1_stride2": (24, 16, 1, 9, 9, 2, (0, 0, 0, 0), 1, True),
    "3x3_flip_false": (24, 16, 3, 9, 7, 1, (1, 1, 1, 1), 1, False),
    "6x6_dilation2": (24, 16, 6, 8, 6, 1, (3, 3, 3, 3), 2, True),
    "7x7_3ch": (3, 16, 7, 12, 10, 1, (3, 3, 3, 3), 1, True),
}


@pytest.mark.parametrize("scale", ["per_sample", "scalar"])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_int8_conv2d_matches_jax_bit_for_bit(case, out, scale):
    C, O, k, H, W, stride, pad, dil, flip = CONV_CASES[case]
    rng = np.random.default_rng(len(case))
    x = (rng.standard_normal((3, H, W, C)) * np.array([1.0, 4.0, 0.25])[:, None, None, None]).astype(np.float32)
    w = (rng.standard_normal((k, k, C, O)) / np.sqrt(C * k * k)).astype(np.float32)
    s = np.float32(0.031) if scale == "scalar" else None
    ref = jq.int8_conv2d(jnp.asarray(x), jnp.asarray(w), padding=pad, stride=stride,
                         lhs_dilation=(dil, dil) if dil > 1 else None, flip_weight=flip,
                         out_dtype=jnp.dtype(out), act_scale=None if s is None else jnp.asarray(s))
    got = tq.int8_conv2d(_nchw(x), torch.from_numpy(w).permute(3, 2, 0, 1), padding=pad, stride=stride,
                         lhs_dilation=dil, flip_weight=flip, out_dtype=getattr(torch, out),
                         act_scale=None if s is None else torch.tensor(s))
    assert got.dtype == getattr(torch, out)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(ref.astype(jnp.float32)))


def test_fold_up_weights_matches_jax_bit_for_bit():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 3, 8, 5)).astype(np.float32)
    f = np.outer([1, 3, 3, 1], [1, 3, 3, 1]).astype(np.float32) / 64
    ref = np.asarray(jax_fold_up_weights(jnp.asarray(w), jnp.asarray(f), gain=4.0))
    got = tq.fold_up_weights(torch.from_numpy(w).permute(3, 2, 0, 1), torch.from_numpy(f), gain=4.0)
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), ref)


@pytest.mark.parametrize("case", ["3x3", "3x3_stride2", "6x6_dilation2", "7x7_3ch"])
def test_kernel_operands_give_the_plain_accumulator(case):
    """What csrc/int8_conv.cu reads, emulated in numpy: for each output phase,
    the K bytes of each pixel (the phase's valid taps in order, Cp channels
    each) gathered from the NHWC activation through the tap table (input row
    i * stride + dy, column j * stride + dx, zero outside the input), dotted
    with the packed weight row."""
    C, O, k, H, W, stride, (px0, px1, py0, py1), dil, _ = CONV_CASES[case]
    g = torch.Generator().manual_seed(5)
    xq = torch.randint(-127, 128, (2, C, H, W), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (O, C, k, k), generator=g, dtype=torch.int8)
    pads = ((py0, py1), (px0, px1))
    acc = tq.int8_conv_reference(xq, wq, torch.ones(()), torch.ones(O), stride, pads, dil, torch.float32)
    ops = tq.kernel_operands(xq, wq, stride, pads, dil)
    phases = tq._phase_taps(k, k, stride, dil, py0, px0)
    cp = ops.x.shape[3]
    assert cp % tq.C_ALIGN == 0 and ops.w.shape[2] % tq.K_STEP == 0 and tuple(acc.shape[2:]) == ops.out_hw
    np.testing.assert_array_equal(ops.x[..., :C].numpy(), xq.permute(0, 2, 3, 1).numpy())
    assert not ops.x[..., C:].any()
    x, w = ops.x.numpy().astype(np.int64), ops.w.numpy().astype(np.int64)
    Ho, Wo = ops.out_hw
    got = np.zeros(acc.shape, np.int64)
    for p, taps in enumerate(phases):
        n_taps = int(ops.ntaps[p])
        assert n_taps == len(taps) and [tuple(r) for r in ops.taps[p, :n_taps].tolist()] == [t[2:] for t in taps]
        assert not w[p, :, n_taps * cp:].any()
        py, px = divmod(p, dil)
        for i in range((Ho - py + dil - 1) // dil):
            for j in range((Wo - px + dil - 1) // dil):
                col = np.zeros((2, n_taps * cp), np.int64)
                for t, (_, _, dy, dx) in enumerate(taps):
                    iy, ix = i * stride + dy, j * stride + dx
                    if 0 <= iy < H and 0 <= ix < W:
                        col[:, t * cp:(t + 1) * cp] = x[:, iy, ix]
                got[:, :, py + dil * i, px + dil * j] = col @ w[p, :, : n_taps * cp].T
    np.testing.assert_array_equal(got, acc.numpy().astype(np.int64))


# ----------------------------------------------------------------------- modules


def _jax_params(module, args, seed):
    """The module's parameters, drawn from a numpy seed (biases 0.1 N(0, 1),
    plus 1 for the affine layers'), with its "quant_scales" left out."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        names = [p.key for p in path]
        if names[-1] == "bias":
            return x * 0.1 + (1.0 if len(names) > 1 and names[-2] == "affine" else 0.0)
        return x
    return {"params": jax.tree_util.tree_map_with_path(draw, shapes)}


def _module_case(name):
    """(JAX ctor(quant), port module, JAX args, port args, output -> NHWC numpy)."""
    rng = np.random.default_rng(7)
    a = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    if name in ("resblock", "resblock_down2"):
        down = 2 if name == "resblock_down2" else 1
        x = a(2, 12, 12, 16)
        return (lambda q: jl.ResBlock(16, 24, activation="lrelu", down=down, quant=q),
                ResBlock(16, 24, activation="lrelu", down=down, quant_site=True), (jnp.asarray(x),), (_nchw(x),))
    if name == "spade_resblock":
        x, feat = a(2, 10, 10, 16), a(2, 10, 10, 128)
        return (lambda q: jsp.SpadeResBlock(16, 24, resolution=128, quant=q),
                SpadeResBlock(16, 24, resolution=128), (jnp.asarray(x), jnp.asarray(feat)),
                (_nchw(x), _nchw(feat)))
    up = 2 if name == "synthesis_layer_up2" else 1
    res = 64 if up == 2 else 16
    x, w = a(2, res // up, res // up, 12), a(2, 32)
    return (lambda q: jsy.SynthesisLayer(12, 16, w_dim=32, resolution=res, up=up, quant=q),
            SynthesisLayer(12, 16, w_dim=32, resolution=res, up=up),
            (jnp.asarray(x), jnp.asarray(w), "none"), (_nchw(x), torch.from_numpy(w), "none"))


@pytest.mark.parametrize("name", ["resblock", "resblock_down2", "spade_resblock", "synthesis_layer",
                                  "synthesis_layer_up2"])
def test_module_int8_matches_jax(name):
    jctor, port, jargs, targs = _module_case(name)
    v = _jax_params(jctor(None), jargs, seed=11)
    missing, unexpected = port.load_state_dict(state_dict_from_jax(v), strict=False)
    # with noise_mode "none" the JAX layer has no noise parameters
    assert not unexpected and all(k.split(".")[-1] in ("noise_const", "noise_strength") for k in missing), missing
    port.eval()
    ref_dyn = np.asarray(jctor("int8").apply(v, *jargs))
    _, mut = jctor("int8_calib").apply(v, *jargs, mutable=["quant_scales"])
    ref_static = np.asarray(jctor("int8_static").apply({**v, **mut}, *jargs))
    jax_scales = quant_scales_from_jax(mut["quant_scales"])
    with torch.no_grad():
        _set_quant(port, "int8")
        dyn = _nhwc(port(*targs))
        _set_quant(port, "int8_calib")
        port(*targs)
        calibrated = tq.quant_scales(port)
        tq.load_quant_scales(port, jax_scales)
        _set_quant(port, "int8_static")
        static = _nhwc(port(*targs))
    assert sorted(calibrated) == sorted(jax_scales)
    for k, s in jax_scales.items():
        assert abs(float(calibrated[k]) - float(s)) <= CALIB_REL * float(s), (k, float(calibrated[k]), float(s))
    assert _rel_l2(dyn, ref_dyn) <= MODULE_REL_L2, _rel_l2(dyn, ref_dyn)
    assert _rel_l2(static, ref_static) <= MODULE_REL_L2, _rel_l2(static, ref_static)


# ---------------------------------------------------------------- state, scales, CLI


@pytest.mark.parametrize("cls", [GeneratorFull, GeneratorV18, Generator512])
def test_state_dict_is_the_same_under_every_mode(cls):
    gen = cls(img_resolution=64, channel_base=512, channel_max=32)
    want = {k: tuple(t.shape) for k, t in gen.state_dict().items()}
    sites = sorted(gen.quant_scales())
    for mode in tq.INT8_MODES + (None,):
        gen.quant = mode
        assert {k: tuple(t.shape) for k, t in gen.state_dict().items()} == want, mode
        assert sorted(gen.quant_scales()) == sites
        assert all(m.quant == mode for m in gen.modules() if isinstance(m, tq.QuantMode))
    with pytest.raises(ValueError, match="quant"):
        gen.quant = "int4"
    with pytest.raises(KeyError, match="missing"):
        gen.load_quant_scales({k: 1.0 for k in sites[1:]})
    with pytest.raises(KeyError, match="extra"):
        gen.load_quant_scales({**{k: 1.0 for k in sites}, "synthesis.nowhere.act_amax": 1.0})
    with pytest.raises(KeyError, match="unsupported JAX collections"):
        state_dict_from_jax({"params": {}, "quant_scales": {}})


def test_cli_serves_int8_static(tmp_path, capsys):
    """cli.test --quant int8_static: one calibration batch, then serving,
    writes its PNG (the CLI refuses non-finite images); an empty calibration
    set is refused with the JAX CLI's message."""
    gen = GeneratorFull(img_resolution=256, channel_base=512, channel_max=32)
    gen.reset_parameters(torch.Generator().manual_seed(0))
    snap = str(tmp_path / "full.pt")
    save_snapshot(snap, gen.state_dict(), torch.zeros(512), {"model": gen.config, "generator": gen.variant})
    written = cli.main(["--network", snap, "--synthetic", "1", "--device", "cpu", "--outdir", str(tmp_path / "out"),
                        "--quant", "int8_static"])
    assert len(written) == 1
    assert "calibrated int8 activation scales on 1 batches" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="no calibration batches"):
        cli.calibrate_int8_static(gen, torch.zeros(512), [])


# ---------------------------------------------------------------- the weight cache


def _int8_builds(module):
    return sum(m.int8_weight.builds for m in module.modules() if isinstance(getattr(m, "int8_weight", None),
                                                                            tq.Int8WeightCache))


@pytest.mark.parametrize("name", ["resblock_down2", "spade_resblock", "synthesis_layer_up2"])
def test_int8_weight_cache(name):
    """The cached int8 weights give the output of a module that builds them
    anew (a fresh copy with the same state), bit for bit; a second forward
    builds nothing; `load_state_dict`, an in-place update of a weight and a
    quant-mode switch each rebuild them."""
    _, port, _, targs = _module_case(name)
    torch.manual_seed(0)
    port.eval()

    def fresh():
        _, m, _, _ = _module_case(name)
        m.load_state_dict(port.state_dict())
        tq.load_quant_scales(m, tq.quant_scales(port))
        _set_quant(m, port_mode[0])
        return m.eval()

    port_mode = ["int8"]
    with torch.no_grad():
        _set_quant(port, "int8")
        y1 = port(*targs)
        n = _int8_builds(port)
        assert n > 0
        y2 = port(*targs)
        assert _int8_builds(port) == n, "a second forward rebuilt a cached weight"
        assert torch.equal(y1, y2) and torch.equal(y1, fresh()(*targs))

        state = {k: v * 1.5 if k.endswith("weight") else v for k, v in port.state_dict().items()}
        port.load_state_dict(state)
        y3 = port(*targs)
        assert _int8_builds(port) == 2 * n and not torch.equal(y3, y1)
        assert torch.equal(y3, fresh()(*targs))

        w = next(m.weight for m in port.modules() if isinstance(getattr(m, "int8_weight", None), tq.Int8WeightCache))
        w.mul_(-1.0)
        y4 = port(*targs)
        assert _int8_builds(port) == 2 * n + 1 and torch.equal(y4, fresh()(*targs))

        _set_quant(port, "int8_calib")
        port(*targs)
        _set_quant(port, "int8_static")
        port_mode[0] = "int8_static"
        y5 = port(*targs)
        assert _int8_builds(port) == 4 * n + 1, "a quant-mode switch kept the weights of the other mode"
        assert torch.equal(y5, fresh()(*targs))
