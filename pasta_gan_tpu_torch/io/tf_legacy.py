"""Legacy TensorFlow StyleGAN2 pickles -> this package's state_dicts
(counterpart of `pasta_gan_tpu/io/tf_legacy.py`; reference `legacy.py`).

A TF StyleGAN2 / StyleGAN2-ADA export is a pickled 3-tuple (G, D, Gs) of
`dnnlib.tflib.network.Network` objects (`legacy.py:20-28`).  Here:

* `_LegacyUnpickler` maps only `dnnlib.tflib.network.Network` (and the stub
  class itself, under this module's or the JAX package's name, so pickles
  written again by either package load) to `TFNetworkStub`, a plain dict of
  the pickled attributes; it allows numpy arrays and plain containers and
  refuses every other global, so no code stored in the pickle ever runs;
* `collect_tf_params` flattens a stub's variables (`legacy.py:76-86`);
* `convert_tf_discriminator` fills the port's `nn/discriminator.py`
  state_dict (`legacy.py:207-287`) and `convert_tf_generator` the
  `models/generator_stock.py` one (`legacy.py:109-204`), both from the TF
  variable names and raising on a missing or mis-shaped tensor.

The name tables are the JAX package's (`_tf_name_for`, `_tf_gen_name_for`),
walked over the port's state_dict keys, which split on "." into the JAX
package's module paths.  The layouts are the reference's:

  conv weight      TF [kh, kw, in, out]   -> OIHW (transpose 3, 2, 0, 1)
  up-conv weight   ("flip")               -> flipped spatially, then OIHW
                   (TF stores the transposed-conv kernel, `legacy.py:181,199`)
  dense weight     ("fcT") [in, out]      -> [out, in]
  modulation bias  ("bias+1")             -> + 1 (TF's init is 0, ours 1)
  const            [1, C, 4, 4]           -> [C, 4, 4]
  noise            [1, 1, H, W]           -> [H, W]

D's `b4.fc` takes TF's Dense0 transposed, as the reference's does: TF, the
reference and the port flatten the 4x4 features NCHW.  (The JAX package
flattens NHWC and copies the same matrix, so its D from a TF pickle is not
the TF network; the port's is.)
"""

from __future__ import annotations

import math
import pickle
import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch


class TFNetworkStub(dict):
    """Stand-in for dnnlib.tflib.network.Network: a dict of the pickled
    attributes (version, static_kwargs, variables, components, ...)."""

    def __setstate__(self, state):
        self.update(state)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e


# the stub under every name it is pickled as: the TF class, this module's, the JAX package's
_STUB_GLOBALS = {
    ("dnnlib.tflib.network", "Network"),
    (__name__, "TFNetworkStub"),
    ("pasta_gan_tpu.io.tf_legacy", "TFNetworkStub"),
}
# what else a legacy TF pickle references: numpy array reconstruction and plain containers
_SAFE_GLOBALS = {
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("collections", "OrderedDict"),
    ("builtins", "set"),
    ("builtins", "frozenset"),
}


class _LegacyUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _STUB_GLOBALS:
            return TFNetworkStub
        if (module, name) in _SAFE_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"{module}.{name} is not allowed in a legacy TF pickle (only numpy arrays and plain containers are)")


def load_tf_network_stubs(f):
    """Unpickle a legacy TF pickle from the binary file `f`: the (G, D, Gs)
    stubs, or None if the payload is not such a 3-tuple (`legacy.py:23-24`).
    A payload that references any other global (a torch pickle, a smuggled
    callable) also gives None: the restricted unpickler stops at it."""
    try:
        data = _LegacyUnpickler(f).load()
    except (pickle.UnpicklingError, AttributeError, ImportError, EOFError):
        return None
    if isinstance(data, tuple) and len(data) == 3 and all(isinstance(net, TFNetworkStub) for net in data):
        return data
    return None


def collect_tf_params(tf_net: TFNetworkStub) -> Dict[str, np.ndarray]:
    """Flatten the variables of a stub and its components (`legacy.py:76-86`)."""
    tf_params: Dict[str, np.ndarray] = {}

    def recurse(prefix, net):
        for name, value in net.variables:
            tf_params[prefix + name] = np.asarray(value)
        for name, comp in dict(net.get("components", {})).items():
            recurse(prefix + name + "/", comp)

    recurse("", tf_net)
    return tf_params


def discriminator_kwargs_from_tf(tf_D: TFNetworkStub) -> dict:
    """TF static_kwargs -> Discriminator arguments (`legacy.py:211-247`);
    raises on an unknown kwarg or a version below 4."""
    if tf_D.version < 4:
        raise ValueError("TensorFlow pickle version too low")
    kw = dict(tf_D.static_kwargs)
    mapped = dict(
        c_dim=kw.get("label_size", 0),
        img_resolution=kw.get("resolution", 1024),
        img_channels=kw.get("num_channels", 3),
        architecture=kw.get("architecture", "resnet"),
        channel_base=kw.get("fmap_base", 16384) * 2,
        channel_max=kw.get("fmap_max", 512),
        conv_clamp=kw.get("conv_clamp", None),
        cmap_dim=kw.get("mapping_fmaps", None),
        activation=kw.get("nonlinearity", "lrelu"),
        mbstd_group_size=kw.get("mbstd_group_size", None),
        mbstd_num_channels=kw.get("mbstd_num_features", 1),
    )
    known = {
        "label_size", "resolution", "num_channels", "architecture", "fmap_base", "fmap_max", "num_fp16_res",
        "conv_clamp", "mapping_fmaps", "nonlinearity", "resample_kernel", "freeze_layers", "mapping_layers",
        "mapping_lrmul", "mbstd_group_size", "mbstd_num_features", "structure",
    }
    unknown = set(kw) - known
    if unknown:
        raise ValueError(f"Unknown TensorFlow kwarg {sorted(unknown)[0]}")
    return mapped


def _tf_name_for(path: Tuple[str, ...], img_resolution: int):
    """A Discriminator state_dict path -> (TF variable name, dense
    transpose?) (the reference's table, `legacy.py:266-285`)."""
    mod, leaf = path[:-1], path[-1]
    m0 = mod[0]
    if m0.startswith("b") and m0 != "b4":
        r = int(m0[1:])
        sub = mod[1]
        if sub == "fromrgb":
            return f"{r}x{r}/FromRGB/{leaf}", False
        if sub in ("conv0", "conv1"):
            i = int(sub[-1])
            return f"{r}x{r}/Conv{i}{['', '_down'][i]}/{leaf}", False
        if sub == "skip":
            return f"{r}x{r}/Skip/{leaf}", False
    if m0 == "b4":
        sub = mod[1]
        if sub == "fromrgb":
            return f"4x4/FromRGB/{leaf}", False
        if sub == "conv":
            return f"4x4/Conv/{leaf}", False
        if sub == "fc":
            return f"4x4/Dense0/{leaf}", leaf == "weight"
        if sub == "out":
            return f"Output/{leaf}", leaf == "weight"
    if m0 == "mapping":
        sub = mod[1]
        if sub == "embed":
            return f"LabelEmbed/{leaf}", leaf == "weight"
        if sub.startswith("fc"):
            return f"Mapping{sub[2:]}/{leaf}", leaf == "weight"
    raise KeyError(f"no TF mapping for the state_dict path {'.'.join(path)}")


def _fill(target: Mapping[str, torch.Tensor], tf_params, name_for) -> Dict[str, torch.Tensor]:
    """A new state_dict with `target`'s keys and shapes, each value the TF
    tensor `name_for(key path)` names, moved by its kind."""
    out = {}
    for key, leaf in target.items():
        tf_name, kind = name_for(tuple(key.split(".")))
        if tf_name not in tf_params:
            raise KeyError(f"TF pickle is missing {tf_name} (for {key})")
        value = np.asarray(tf_params[tf_name], np.float32)
        if kind == "fcT":
            value = value.T
        elif kind == "flip":
            value = value[::-1, ::-1]
        elif kind == "bias+1":
            value = value + 1.0
        elif kind == "const":
            value = value[0]
        elif kind == "noise":
            value = value[0, 0]
        if value.ndim == 4:  # TF conv [kh, kw, in, out] -> OIHW
            value = value.transpose(3, 2, 0, 1)
        if value.shape != tuple(leaf.shape):
            raise ValueError(f"{tf_name}: TF shape {value.shape} != ours {tuple(leaf.shape)} at {key}")
        # np.array, not ascontiguousarray: that promotes 0-d scalars (noise_strength) to 1-d
        out[key] = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))
    return out


def convert_tf_discriminator(tf_D: TFNetworkStub, state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fill a Discriminator state_dict (`state_dict` gives the keys and
    shapes) from a TF stub; progressive-growing exports name the top FromRGB
    by lod (`legacy.py:256-261`)."""
    img_resolution = discriminator_kwargs_from_tf(tf_D)["img_resolution"]
    tf_params = collect_tf_params(tf_D)
    for name, value in list(tf_params.items()):
        match = re.fullmatch(r"FromRGB_lod(\d+)/(.*)", name)
        if match:
            r = img_resolution // (2 ** int(match.group(1)))
            tf_params[f"{r}x{r}/FromRGB/{match.group(2)}"] = value

    def name_for(path):
        tf_name, transpose = _tf_name_for(path, img_resolution)
        return tf_name, "fcT" if transpose else "plain"

    return _fill(state_dict, tf_params, name_for)


DISCRIMINATOR_ARGS = ("c_dim", "img_resolution", "img_channels", "architecture", "channel_base", "channel_max",
                      "conv_clamp", "cmap_dim", "mbstd_group_size", "mbstd_num_channels")


def discriminator_from_tf(tf_D: TFNetworkStub):
    """TF stub -> (Discriminator, its converted state_dict), on the CPU."""
    from ..nn.discriminator import Discriminator

    kwargs = {k: v for k, v in discriminator_kwargs_from_tf(tf_D).items() if k in DISCRIMINATOR_ARGS}
    disc = Discriminator(**kwargs)
    sd = convert_tf_discriminator(tf_D, disc.state_dict())
    disc.load_state_dict(sd, strict=True)
    return disc, sd


def generator_kwargs_from_tf(tf_G: TFNetworkStub) -> dict:
    """TF static_kwargs -> GeneratorStock arguments (`legacy.py:116-155`);
    raises on an unknown kwarg like the reference."""
    if tf_G.version < 4:
        raise ValueError("TensorFlow pickle version too low")
    kw = dict(tf_G.static_kwargs)

    def get(name, default=None, none=None):
        val = kw.get(name, default)
        return val if val is not None else none

    mapped = dict(
        z_dim=get("latent_size", 0),
        c_dim=get("label_size", 512),
        w_dim=get("dlatent_size", 512),
        img_resolution=get("resolution", 1024),
        img_channels=get("num_channels", 3),
        mapping_kwargs=dict(
            num_layers=get("mapping_layers", 8),
            embed_features=get("label_fmaps", None),
            layer_features=get("mapping_fmaps", None),
            activation=get("mapping_nonlinearity", "lrelu"),
            lr_multiplier=get("mapping_lrmul", 0.01),
            w_avg_beta=get("w_avg_beta", 0.995, none=1),
        ),
        synthesis_kwargs=dict(
            channel_base=get("fmap_base", 16384) * 2,
            channel_max=get("fmap_max", 512),
            num_fp16_res=get("num_fp16_res", 0),
            conv_clamp=get("conv_clamp", None),
            architecture=get("architecture", "skip"),
            resample_filter=tuple(get("resample_kernel", (1, 3, 3, 1))),
            use_noise=get("use_noise", True),
            activation=get("nonlinearity", "lrelu"),
        ),
    )
    known = {
        "latent_size", "label_size", "dlatent_size", "resolution", "num_channels", "mapping_layers", "label_fmaps",
        "mapping_fmaps", "mapping_nonlinearity", "mapping_lrmul", "w_avg_beta", "fmap_base", "fmap_max",
        "num_fp16_res", "conv_clamp", "architecture", "resample_kernel", "use_noise", "nonlinearity",
        # consumed and ignored, as in the reference (`legacy.py:148-152`)
        "truncation_psi", "truncation_cutoff", "style_mixing_prob", "structure",
    }
    unknown = set(kw) - known
    if unknown:
        raise ValueError(f"Unknown TensorFlow kwarg {sorted(unknown)[0]}")
    return mapped


def _tf_gen_name_for(path: Tuple[str, ...]):
    """A GeneratorStock state_dict path -> (TF name, kind); the kinds are
    the module docstring's layout moves (`legacy.py:170-202`)."""
    mod, leaf = path[:-1], path[-1]
    comp = mod[0]
    if comp == "mapping":
        sub = mod[1]
        if sub == "embed":
            return f"mapping/LabelEmbed/{leaf}", "fcT" if leaf == "weight" else "plain"
        if sub.startswith("fc"):
            return f"mapping/Dense{sub[2:]}/{leaf}", "fcT" if leaf == "weight" else "plain"
    if comp == "synthesis":
        r = int(mod[1][1:])  # "b{r}"
        if leaf == "const":
            return f"synthesis/{r}x{r}/Const/const", "const"
        sub = mod[2]
        lod = int(math.log2(r))
        tf_layer = {"conv0": "Conv0_up", "conv1": "Conv" if r == 4 else "Conv1", "torgb": "ToRGB", "skip": "Skip"}[sub]
        if leaf == "noise_const":
            k = 0 if r == 4 else (2 * lod - 5 if sub == "conv0" else 2 * lod - 4)
            return f"synthesis/noise{k}", "noise"
        if len(mod) > 3 and mod[3] == "affine":
            tf_leaf = {"weight": "mod_weight", "bias": "mod_bias"}[leaf]
            return f"synthesis/{r}x{r}/{tf_layer}/{tf_leaf}", "fcT" if leaf == "weight" else "bias+1"
        kind = "flip" if leaf == "weight" and sub in ("conv0", "skip") else "plain"
        return f"synthesis/{r}x{r}/{tf_layer}/{leaf}", kind
    raise KeyError(f"no TF mapping for the state_dict path {'.'.join(path)}")


def convert_tf_generator(tf_G: TFNetworkStub, state_dict: Mapping[str, torch.Tensor]):
    """Fill a GeneratorStock state_dict (parameters and `noise_const`
    buffers; `state_dict` gives the keys and shapes) from a TF stub.
    Returns (state_dict, w_avg): `w_avg` is the pickle's `dlatent_avg`, a
    train-state tensor here, not a module buffer (nn/mapping.py).
    Progressive-growing exports name the top ToRGB by lod
    (`legacy.py:160-165`)."""
    tf_params = collect_tf_params(tf_G)
    img_resolution = generator_kwargs_from_tf(tf_G)["img_resolution"]
    for name, value in list(tf_params.items()):
        match = re.fullmatch(r"ToRGB_lod(\d+)/(.*)", name)
        if match:
            r = img_resolution // (2 ** int(match.group(1)))
            tf_params[f"synthesis/{r}x{r}/ToRGB/{match.group(2)}"] = value
    out = _fill(state_dict, tf_params, _tf_gen_name_for)
    return out, torch.from_numpy(np.array(tf_params["dlatent_avg"], dtype=np.float32))


def generator_stock_from_tf(tf_G: TFNetworkStub):
    """TF stub -> (GeneratorStock loaded with its weights, on the CPU, its
    state_dict, w_avg).  Lod-suffixed ToRGBs imply the "orig" architecture
    (`legacy.py:164-165`)."""
    from ..models.generator_stock import GeneratorStock

    kwargs = generator_kwargs_from_tf(tf_G)
    if any(name.startswith("ToRGB_lod") for name in collect_tf_params(tf_G)):
        kwargs["synthesis_kwargs"]["architecture"] = "orig"
    gen = GeneratorStock(**kwargs)
    sd, w_avg = convert_tf_generator(tf_G, gen.state_dict())
    gen.load_state_dict(sd, strict=True)
    return gen, sd, w_avg
