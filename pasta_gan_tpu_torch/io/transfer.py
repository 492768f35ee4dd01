"""Transfer-learning resume from a network pickle (counterpart of
`pasta_gan_tpu/io/transfer.py`).

The reference's `--resume <pickle>` (`training_loop_wo_flow_fullbody.py:280-285`)
copies tensors into the freshly built G, D and G_ema by name with
`require_all=False` (`torch_utils/misc.py:copy_params_and_buffers`): a
tensor whose name and shape agree transfers, every other keeps its fresh
init.  Its resume presets (`train_wo_flow_fullbody.py:319-325`) are legacy
TensorFlow exports, converted on the fly by `legacy.py`.

Here the pickle becomes state_dicts with the port's names (`io/tf_legacy.py`
for a TF export, `state_dict_from_reference_pickle` for a reference torch
snapshot) and `copy_matching` merges them into the train state's modules.
The port's modules carry the reference's state_dict names, so the JAX
package's `convert_reference_partial` (its `_ref_key` and layout moves)
reduces to the copy by name and shape.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch


def copy_matching(dst_state_dict: Mapping[str, torch.Tensor], src_state_dict: Mapping[str, object]
                  ) -> Tuple[Dict[str, torch.Tensor], List[str], List[str]]:
    """The require_all=False copy: every dst entry whose name is in src with
    the same shape takes src's value (in dst's dtype, on dst's device);
    every other keeps dst's.  Returns (merged, copied names, names whose
    shapes differ)."""
    merged, copied, mismatched = {}, [], []
    for name, leaf in dst_state_dict.items():
        merged[name] = leaf
        if name not in src_state_dict:
            continue
        src = src_state_dict[name]
        src = src if torch.is_tensor(src) else torch.from_numpy(np.asarray(src))
        if tuple(src.shape) != tuple(leaf.shape):
            mismatched.append(name)
            continue
        copied.append(name)
        merged[name] = src.to(device=leaf.device, dtype=leaf.dtype)
    return merged, copied, mismatched


def state_dict_from_reference_pickle(path: str, key: str = "G_ema") -> Dict[str, np.ndarray]:
    """{name: array} of one network (default G_ema) of a reference
    network-snapshot pickle, or {} if the snapshot has no `key` (JAX
    `io/torch_import.py:25-62`): `named_parameters()` and `named_buffers()`
    of the unpickled module, as numpy.

    The reference pickles its modules with their source
    (`torch_utils/persistence.py`), so this runs `pickle.load`, which runs
    code stored in the file: load only snapshots you trust.  Unpickling
    needs the reference's import hooks (`torch_utils`, `dnnlib`) on the
    path; without them this raises naming them.  A legacy TF pickle is
    refused: it goes through `io/tf_legacy.py`."""
    from .tf_legacy import load_tf_network_stubs

    with open(path, "rb") as f:
        stubs = load_tf_network_stubs(f)
    if stubs is not None:
        raise ValueError(f"{path} is a legacy TensorFlow StyleGAN2 pickle; use "
                         "io.tf_legacy.generator_stock_from_tf / convert_tf_discriminator")
    with open(path, "rb") as f:
        try:
            data = pickle.load(f)
        except ModuleNotFoundError as e:
            raise ModuleNotFoundError(
                f"{path}: unpickling a reference snapshot needs the reference's import hooks "
                f"(torch_utils.persistence and dnnlib on the Python path); {e}") from e
    g = data.get(key) if isinstance(data, dict) else data
    if g is None:
        return {}
    return {name: t.detach().cpu().numpy() for name, t in list(g.named_parameters()) + list(g.named_buffers())}


def _tf_sources(path: str):
    """A legacy TF pickle -> (G state_dict, D state_dict, w_avg) in the
    port's names, or None if the file is not such a pickle."""
    from .tf_legacy import discriminator_from_tf, generator_stock_from_tf, load_tf_network_stubs

    with open(path, "rb") as f:
        stubs = load_tf_network_stubs(f)
    if stubs is None:
        return None
    _G, tf_D, tf_Gs = stubs
    _, g_sd, w_avg = generator_stock_from_tf(tf_Gs)
    _, d_sd = discriminator_from_tf(tf_D)
    return g_sd, d_sd, w_avg


def transfer_from_network_pickle(state, path: str, verbose: bool = True):
    """Copy a network pickle into a fresh TrainState by name and shape
    (`training_loop...py:280-285`).  The pickle's generator (a TF export's
    Gs, a reference snapshot's G_ema) lands in both G and G_ema, its D in D;
    its `dlatent_avg` / `mapping.w_avg` becomes w_avg when the shapes agree.
    The step, the Adam states, pl_mean and the ADA counters stay fresh.
    Returns `state`, changed in place, and prints the counts when `verbose`."""
    src = _tf_sources(path)
    if src is not None:
        g_src, d_src, w_avg = src
    else:
        g_src = state_dict_from_reference_pickle(path, key="G_ema")
        d_src = state_dict_from_reference_pickle(path, key="D") or None
        w_avg = g_src.get("mapping.w_avg")

    counts = {}
    for name, src_sd in (("G", g_src), ("G_ema", g_src), ("D", d_src)):
        if src_sd is None:
            counts[name] = ([], [])
            continue
        module = getattr(state, name)
        merged, copied, mismatched = copy_matching(module.state_dict(), src_sd)
        module.load_state_dict(merged, strict=True)
        counts[name] = (copied, mismatched)
    if w_avg is not None and tuple(np.shape(w_avg)) == tuple(state.w_avg.shape):
        with torch.no_grad():
            state.w_avg.copy_(torch.as_tensor(np.asarray(w_avg, np.float32)))
    if verbose:
        (gc, gm), (dc, dm) = counts["G"], counts["D"]
        print(f'Transferred from "{path}": G {len(gc)} leaves ({len(gm)} shape-skipped), '
              f"D {len(dc)} leaves ({len(dm)} shape-skipped)")
    return state
