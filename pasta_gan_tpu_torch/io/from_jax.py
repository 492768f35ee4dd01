"""JAX GeneratorFull variables -> this package's GeneratorFull state_dict.

The reverse of `pasta_gan_tpu/io/torch_import.py:_ref_key`, kept here so the
port never imports the JAX package.  `variables` is the JAX package's nested
dict ({"params": {...}}) with numpy (or array-like) leaves.

Layout translations:
  conv weight   HWIO            -> OIHW      (transpose 3, 2, 0, 1)
  flax Dense    kernel [in,out] -> Linear weight [out, in]
  flax Conv     kernel HWIO     -> OIHW
  eq-lr FC      [out, in]       -> [out, in] (copy)
  const         [H, W, C]       -> [C, H, W]
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
    """Translate JAX GeneratorFull `variables` into a port state_dict.

    Raises on a collection other than "params", and, when `expected` (the
    target module's state_dict) is given, on any missing, extra or mis-shaped
    key.  Load the result with `load_state_dict(..., strict=True)`."""
    extra_collections = set(variables) - {"params"}
    if extra_collections:
        raise KeyError(f"unsupported JAX collections: {sorted(extra_collections)}")
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(variables["params"]):
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
    if expected is not None:
        missing = sorted(set(expected) - set(out))
        extra = sorted(set(out) - set(expected))
        if missing or extra:
            raise KeyError(f"state_dict mismatch: missing {missing[:10]}, extra {extra[:10]}")
        for k, v in out.items():
            if tuple(v.shape) != tuple(expected[k].shape):
                raise ValueError(f"shape mismatch for {k}: {tuple(v.shape)} vs {tuple(expected[k].shape)}")
    return out
