"""JAX variables -> this package's state_dicts: GeneratorFull, GeneratorV18, Discriminator, VGG19,
and the metrics' SimpleConvFeatures; and a generator's int8 "quant_scales" collection ->
its activation sites (`quant_scales_from_jax`).

The reverse of `pasta_gan_tpu/io/torch_import.py:_ref_key`, kept here so the
port never imports the JAX package.  `variables` is the JAX package's nested
dict ({"params": {...}}, with a generator's "buffers" beside it) with
numpy (or array-like) leaves.

Layout translations:
  conv weight   HWIO            -> OIHW      (transpose 3, 2, 0, 1)
  flax Dense    kernel [in,out] -> Linear weight [out, in]
  flax Conv     kernel HWIO     -> OIHW
  eq-lr FC      [out, in]       -> [out, in] (copy)
  const         [H, W, C]       -> [C, H, W]
  D b4.fc       [out, H*W*C]    -> [out, C*H*W] (JAX flattens NHWC, the port NCHW)
  VGG19 conv{i} -> torchvision's features.{layer}
  SimpleConvFeatures kernels[i] HWIO -> kernel{i} OIHW; proj [256, dim] (copy)
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module_name(comp: str, seg: str) -> str:
    """One JAX submodule name -> the reference's dotted name, in context."""
    m = re.fullmatch(r"layers_(\d+)", seg)
    if m:
        return m.group(1)
    if comp == "const_encoding":
        if seg == "stem":
            return "model.0"
        m = re.fullmatch(r"down(\d+)", seg)
        if m:
            return f"model.{int(m.group(1)) + 1}"
    if comp == "feat_enc":
        if seg == "conv0":
            return "0"
        m = re.fullmatch(r"down(\d+)", seg)
        if m:
            return str(int(m.group(1)) + 1)
    if comp == "style_encoding":
        if seg == "stem":
            return "model.0"
        m = re.fullmatch(r"(dense|down|conv)(\d+)", seg)
        if m:
            i = int(m.group(2))
            return f"model.{2 * i + 1}" if m.group(1) == "dense" else f"model.{2 * i + 2}"
    return seg


def port_key(path: Tuple[str, ...]) -> Tuple[str, str]:
    """JAX param path (without the collection) -> (port state_dict key, kind)."""
    *mods, leaf = path
    names = []
    for i, seg in enumerate(mods):
        comp = mods[i - 1] if i > 0 else ""
        names.append(_module_name(comp, seg))
    if leaf == "kernel":  # flax Dense ([in, out]) or Conv (HWIO)
        return ".".join(names + ["weight"]), "dense"
    if leaf == "const":
        return ".".join(names + ["const"]), "const"
    return ".".join(names + [leaf]), "param"


def state_dict_from_jax(variables, expected: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """Translate JAX GeneratorFull, GeneratorV18 or Generator512 `variables`
    into a port state_dict (the V18 mask heads `m_weight1` / `m_weight2` are
    1x1 HWIO convs like every other weight; the "buffers" collection holds
    each synthesis layer's `noise_const` map, a persistent buffer of the
    port).

    Raises on a collection other than "params" and "buffers", and, when
    `expected` (the target module's state_dict) is given, on any missing,
    extra or mis-shaped key.  Load the result with
    `load_state_dict(..., strict=True)`."""
    extra_collections = set(variables) - {"params", "buffers"}
    if extra_collections:
        raise KeyError(f"unsupported JAX collections: {sorted(extra_collections)}")
    out: Dict[str, torch.Tensor] = {}
    leaves = [(path, leaf) for coll in ("params", "buffers") for path, leaf in _flatten(variables.get(coll, {}))]
    for path, leaf in leaves:
        key, kind = port_key(path)
        a = np.asarray(leaf, dtype=np.float32)
        if kind == "dense" and a.ndim == 2:
            a = a.T
        elif kind == "const":
            a = a.transpose(2, 0, 1)
        elif a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        if key in out:
            raise KeyError(f"two JAX leaves map to {key}")
        out[key] = torch.from_numpy(np.array(a, order="C", copy=True))
    return _checked(out, expected)


def quant_scales_from_jax(scales) -> Dict[str, torch.Tensor]:
    """A JAX generator's "quant_scales" collection (each site's `act_amax`)
    -> {site name: fp32 scalar}, named by the same translation as the
    parameters: what `GeneratorFull.load_quant_scales` takes (it raises on a
    missing or an unknown site)."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(scales):
        key, _ = port_key(path)
        out[key] = torch.tensor(float(np.asarray(leaf, dtype=np.float32)), dtype=torch.float32)
    return out


def _checked(out, expected):
    if expected is not None:
        missing = sorted(set(expected) - set(out))
        extra = sorted(set(out) - set(expected))
        if missing or extra:
            raise KeyError(f"state_dict mismatch: missing {missing[:10]}, extra {extra[:10]}")
        for k, v in out.items():
            if tuple(v.shape) != tuple(expected[k].shape):
                raise ValueError(f"shape mismatch for {k}: {tuple(v.shape)} vs {tuple(expected[k].shape)}")
    return out


def discriminator_state_dict_from_jax(variables, expected: Optional[Mapping[str, torch.Tensor]] = None):
    """JAX Discriminator `variables` -> the port's Discriminator state_dict
    (same checks as `state_dict_from_jax`)."""
    out = state_dict_from_jax(variables)
    w = out.get("b4.fc.weight")
    if w is not None:
        res = 4
        n_out, n_in = w.shape
        out["b4.fc.weight"] = (w.reshape(n_out, res, res, n_in // (res * res)).permute(0, 3, 1, 2)
                               .reshape(n_out, n_in).contiguous())
    return _checked(out, expected)


def vgg19_state_dict_from_jax(variables, expected: Optional[Mapping[str, torch.Tensor]] = None):
    """JAX `VGG19Features` variables (conv{i}.kernel/bias) -> the port's
    VGG19Features state_dict (torchvision names, features.{layer}.weight)."""
    from ..train.vgg import VGG19_CONV_LAYERS

    out = {}
    for key, v in state_dict_from_jax(variables).items():
        m = re.fullmatch(r"conv(\d+)\.(weight|bias)", key)
        if m is None or int(m.group(1)) >= len(VGG19_CONV_LAYERS):
            raise KeyError(f"unexpected VGG19 leaf {key}")
        out[f"features.{VGG19_CONV_LAYERS[int(m.group(1))]}.{m.group(2)}"] = v
    return _checked(out, expected)


def simpleconv_state_dict_from_jax(kernels, proj, expected: Optional[Mapping[str, torch.Tensor]] = None):
    """The JAX `metrics/extractors.py:SimpleConvFeatures`' `kernels` (four
    HWIO arrays) and `proj` [256, dim] -> the port's SimpleConvFeatures
    state_dict (`kernel{i}` OIHW, `proj`).  Raises on a kernel that is not
    4-D and, with `expected`, on any missing, extra or mis-shaped key."""
    out = {}
    for i, k in enumerate(kernels):
        k = np.asarray(k, dtype=np.float32)
        if k.ndim != 4:
            raise ValueError(f"SimpleConvFeatures kernel {i} has shape {k.shape}, expected HWIO")
        out[f"kernel{i}"] = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    out["proj"] = torch.from_numpy(np.array(proj, dtype=np.float32))
    return _checked(out, expected)
