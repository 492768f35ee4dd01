"""Shared parity machinery of tests/test_torch_zoo_*.py: the port's zoo
classes (pasta_gan_tpu_torch/models/generator_v1[0-5,7].py, generator_v21.py,
generator_ablations.py) against the JAX package's, on the CPU.

* Inputs from a numpy seed, batch 2: the style stack at the class's
  `style_input_nc` (at a quarter of the resolution, or at the full one for
  the raw-garment encoders), retain 3 channels, pose 6, the denorm garments,
  and binary masks whose second sample is all zero, so that every `> 10`
  valid-pixel fallback runs in that sample and not in the first.
* The JAX tree is `test_torch_generator._jax_variables`' (noise_const in
  "buffers"), carried by `state_dict_from_jax(..., expected=port.state_dict())`
  into a strict load; both forwards run with noise_mode "const".
* Gates: the sigmoid masks pass `> 0.9`, and a rounding difference at the
  threshold flips a pixel.  `Pair._shift` scales the weight of each gating
  mask head (in the JAX tree and the port alike) so that its logits spread
  with a standard deviation of 6, and moves its bias so that the threshold
  falls into the widest gap between the port's logits within their 20-80 %
  quantiles (inside the port's forward, from that head's own output); `Pair.outputs` then asserts on JAX's masks that
  20-80 % of the pixels pass, that none lies within 1e-5 of 0.9, and that the
  port's binarised masks equal JAX's exactly.
* Full-width keys and shapes with nothing allocated: JAX through
  `jax.eval_shape` of `init`, the port built on the meta device.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pasta_gan_tpu import models as jax_models
from pasta_gan_tpu_torch import models
from pasta_gan_tpu_torch.io.from_jax import port_key, state_dict_from_jax

from test_torch_generator import _jax_variables

N = 2
IMG_RTOL, IMG_ATOL, FINETUNE_ATOL = 1e-2, 5e-3, 1e-2  # tests/test_torch_generator.py's generator limits
THRESHOLD, MARGIN = 0.9, 1e-5
GATE_SHARE = (0.2, 0.8)
LOGIT_STD = 6.0  # the gating heads' logits, spread as a trained mask head's are (nearly binary masks)
FULL = dict(img_resolution=256, channel_base=16384, channel_max=512)  # the classes' defaults

# the forwards' inputs after (z, c, retain, pose)
SPADE = ("denorm_input",)
V15 = ("denorm_input", "denorm_mask")
SINGLE = ("denorm_clothes", "denorm_mask")
V21 = ("denorm_clothes", "denorm_mask", "face_mask")
FOUR = ("denorm_upper_input", "denorm_lower_input", "denorm_upper_mask", "denorm_lower_mask")
RAW_STYLE = ("GeneratorRaw", "GeneratorRawFull")  # style encoders over the full-resolution garment


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread while a zoo module runs: the test workers
    share the machine's cores, and oversubscribed OpenMP threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def inputs(name, keys, R, nc, seed=0):
    rng = np.random.default_rng(seed)
    cr = R if name in RAW_STYLE else R // 4
    inp = dict(c=rng.standard_normal((N, cr, cr, nc)).astype(np.float32) * 0.5,
               retain=rng.standard_normal((N, R, R, 3)).astype(np.float32) * 0.5,
               pose=rng.standard_normal((N, R, R, 6)).astype(np.float32) * 0.5)
    for k in keys:
        if "mask" in k:
            m = (rng.uniform(size=(N, R, R, 1)) > 0.4).astype(np.float32)
            m[1] = 0.0  # the second sample has no valid pixel: the fallbacks run there
            inp[k] = m
        else:
            inp[k] = rng.standard_normal((N, R, R, 3)).astype(np.float32) * 0.5
    return inp


def _torgb_capture(mdl, method):
    return method == "__call__" and mdl.name == "torgb"


class Pair:
    """One class's JAX module and tree, its port with the tree loaded, and
    the inputs; `gate` is (JAX module path, port module path, bias names) of
    the ToRGB whose mask heads feed the thresholds, or None."""

    def __init__(self, name, cfg, keys, seed=0, gate=None, **jax_kwargs):
        self.name, self.keys, self.gate = name, keys, gate
        self.port = models.build_model(name, **cfg)
        self.inp = inputs(name, keys, cfg["img_resolution"], self.port.config["style_input_nc"], seed)
        self.jgen = jax_models.MODEL_REGISTRY[name](**cfg, **jax_kwargs)
        self.v = _jax_variables(self.jgen, self.inp, seed=seed + 1)
        self.port.load_state_dict(state_dict_from_jax(self.v, self.port.state_dict()), strict=True)
        self.port.eval()

    def run_port(self, shift_gates=False):
        """The port's outputs (numpy) and the gating ToRGB's masks (NHWC).
        With `shift_gates`, the gating heads are first moved (`_shift`) from
        their own output in this forward, which then goes on with them."""
        caught = []

        def hook(torgb, args, out):
            if shift_gates:
                self._shift(torgb, [m.double() for m in _heads(out[1])])
                out = torgb.forward(*args)
            caught.append(out[1])
            return out

        handle = self.port.get_submodule(self.gate[1]).register_forward_hook(hook) if self.gate else None
        try:
            with torch.no_grad():
                out = self.port(None, *[torch.from_numpy(self.inp[k]) for k in ("c", "retain", "pose") + self.keys],
                                noise_mode="const")
        finally:
            if handle:
                handle.remove()
        out = out if isinstance(out, tuple) else (out,)
        masks = [m.permute(0, 2, 3, 1).numpy() for m in _heads(caught[0])] if caught else []  # NCHW -> NHWC
        return [o.numpy() for o in out], masks

    def run_jax(self):
        x = {k: jnp.asarray(a) for k, a in self.inp.items()}
        fn = jax.jit(lambda v, x: self.jgen.apply(v, None, **x, noise_mode="const",
                                                  capture_intermediates=_torgb_capture, mutable=["intermediates"]))
        out, state = fn(self.v, x)
        out = out if isinstance(out, tuple) else (out,)
        masks = []
        if self.gate:
            node = state["intermediates"]
            for seg in self.gate[0]:
                node = node[seg]
            masks = [np.asarray(m) for m in _heads(node["torgb"]["__call__"][0][1])]
        return [np.asarray(o) for o in out], masks

    def _shift(self, torgb, masks):
        """Spread each gating head's logits to a standard deviation of
        LOGIT_STD (its weight scaled) and move its bias so that the threshold
        sits in the widest gap of the logits within their 20-80 % quantiles;
        the JAX tree gets the same head."""
        jax_node = self.v["params"]
        for seg in self.gate[0] + ("torgb",):
            jax_node = jax_node[seg]
        for bias_name, m in zip(self.gate[2], masks):
            weight_name = bias_name.replace("bias", "weight")
            # the logits less the bias
            y = (torch.logit(m) - float(getattr(torgb, bias_name).detach())).flatten().numpy()
            scale = LOGIT_STD / y.std()
            y = np.sort(y * scale)
            lo, hi = int(GATE_SHARE[0] * y.size) + 1, int(GATE_SHARE[1] * y.size) - 1
            k = lo + int(np.argmax(np.diff(y[lo : hi + 1])))
            bias = math.log(THRESHOLD / (1 - THRESHOLD)) - 0.5 * (y[k] + y[k + 1])
            jax_node[weight_name] = (np.asarray(jax_node[weight_name]) * np.float32(scale)).astype(np.float32)
            jax_node[bias_name] = np.full_like(np.asarray(jax_node[bias_name]), bias, dtype=np.float32)
            for name in (weight_name, bias_name):
                leaf = np.asarray(jax_node[name])
                with torch.no_grad():
                    getattr(torgb, name).copy_(torch.from_numpy(leaf.transpose(3, 2, 0, 1) if leaf.ndim == 4 else leaf))

    def outputs(self):
        """(port outputs, JAX outputs), with the gates checked.  The port runs
        once (its gates moved then); a later call with another `jgen` (the
        JAX class with other options, on the same tree) runs JAX alone."""
        if not hasattr(self, "_port"):
            self._port = self.run_port(shift_gates=bool(self.gate))
        ours, port_masks = self._port
        ref, jax_masks = self.run_jax()
        for i, (a, b) in enumerate(zip(port_masks, jax_masks)):
            share = float((b > THRESHOLD).mean())
            margin = float(np.abs(b - THRESHOLD).min())
            print(f"{self.name} gate head {i}: {share:.3f} of the JAX mask above {THRESHOLD}, nearest {margin:.3g}")
            assert GATE_SHARE[0] <= share <= GATE_SHARE[1], share
            assert margin > MARGIN, "a JAX mask value at the threshold"
            np.testing.assert_array_equal(a > THRESHOLD, b > THRESHOLD)
        self.jax_masks = jax_masks
        return ours, ref


def _heads(aux):
    return list(aux) if isinstance(aux, (tuple, list)) else [aux]


def assert_close(name, ours, ref, finetune=()):
    """Every output within the generator limits (`finetune`: the indices of
    finetune images, atol 1e-2); prints the relative L2 of each."""
    assert len(ours) == len(ref), (name, len(ours), len(ref))
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert a.shape == b.shape, (name, i, a.shape, b.shape)
        assert np.isfinite(a).all(), (name, i)
        print(f"{name} output {i} {a.shape}: relative L2 against JAX {rel_l2(a, b):.3g}")
        np.testing.assert_allclose(a, b, rtol=IMG_RTOL, atol=FINETUNE_ATOL if i in finetune else IMG_ATOL,
                                   err_msg=f"{name} output {i}")


def valid_counts(mask, denorm_mask):
    """Per sample, the valid pixels (both masks above 0.9) at half resolution."""
    m = (mask[:, ::2, ::2] > THRESHOLD) & (denorm_mask[:, ::2, ::2] > THRESHOLD)
    return m.reshape(m.shape[0], -1).sum(axis=1)


def assert_fallback_ran(mask, denorm_mask):
    """The first sample averages over more than 10 valid pixels, the second
    (no denorm pixel) falls back to the whole map."""
    counts = valid_counts(mask, denorm_mask)
    assert counts[0] > 10 and counts[1] <= 10, counts


def _port_shape(path, shape):
    key, kind = port_key(path)
    if kind == "dense" and len(shape) == 2:
        return key, tuple(reversed(shape))
    if kind == "const":
        return key, (shape[2], shape[0], shape[1])
    if len(shape) == 4:
        return key, (shape[3], shape[2], shape[0], shape[1])
    return key, tuple(shape)


def full_width_keys_and_shapes(name, keys):
    """The JAX class at its defaults (`jax.eval_shape` of `init`) and the
    port's (on the meta device) have the same state_dict keys and shapes."""
    with torch.device("meta"):
        port = models.build_model(name)
    jgen = jax_models.MODEL_REGISTRY[name]()
    inp = inputs(name, keys, FULL["img_resolution"], port.config["style_input_nc"])
    structs = {k: jax.ShapeDtypeStruct((1,) + a.shape[1:], jnp.float32) for k, a in inp.items()}
    shapes = jax.eval_shape(lambda x: jgen.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                                                None, **x, noise_mode="const"), structs)
    expected = {}
    for coll in ("params", "buffers"):
        for path, leaf in jax.tree_util.tree_leaves_with_path(shapes[coll]):
            key, shape = _port_shape(tuple(p.key for p in path), leaf.shape)
            assert key not in expected, key
            expected[key] = shape
    got = {k: tuple(t.shape) for k, t in port.state_dict().items()}
    assert sorted(got) == sorted(expected), (sorted(set(got) ^ set(expected)))[:10]
    assert got == expected
    return len(got), sum(math.prod(s) for s in got.values())
