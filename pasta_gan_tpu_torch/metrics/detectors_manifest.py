"""Detector-weights manifest and local discovery (a copy of
`pasta_gan_tpu/metrics/detectors_manifest.py`, with the same files and the
same lookup order, so a weights file serves both packages).

The reference computes its published-protocol metrics with two NVIDIA
TorchScript detectors (`metrics/frechet_inception_distance.py:22`,
`metrics/perceptual_path_length.py:97`).  Nothing here downloads them: once a
file is on disk, `cli.calc_metrics --detector auto` finds it with no new
code.

Lookup order for each detector (first hit wins):
  1. every directory in `$PASTA_GAN_DETECTORS` (os.pathsep-separated),
  2. `<repo>/weights/`,
  3. `~/.cache/pasta_gan_tpu/detectors/`.

Accepted formats per detector (all reach the same compute path):
  * the reference's TorchScript `.pt` (`metrics/inception.py` and
    `metrics/vgg16.py` read its parameters through `torch.jit.load`, with the
    `layers.` wrapper stripped),
  * a plain torch `state_dict` checkpoint (`torchvision` naming for vgg16,
    `pytorch-fid` pt_inception naming for inception),
  * an `.npz` export of either state_dict.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional

# sha256 values are recorded on first verified download (`verify_detector`
# prints the computed digest); they are intentionally None here rather than
# guessed.
DETECTORS: Dict[str, dict] = {
    "inception": dict(
        url="https://nvlabs-fi-cdn.nvidia.com/stylegan2-ada-pytorch/pretrained/metrics/inception-2015-12-05.pt",
        filenames=("inception-2015-12-05.pt", "pt_inception-2015-12-05-6726825d.pth",
                   "inception.npz"),
        sha256=None,
        used_by=("fid50k_full", "fid50k", "kid50k_full", "kid50k", "is50k"),
        notes="2048-d pool features + 1008-way logits; metrics/inception.py "
              "loads either naming into its InceptionV3Features module.",
    ),
    "vgg16": dict(
        url="https://nvlabs-fi-cdn.nvidia.com/stylegan2-ada-pytorch/pretrained/metrics/vgg16.pt",
        filenames=("vgg16.pt", "vgg16-397923af.pth", "vgg16.npz"),
        sha256=None,
        used_by=("pr50k3_full", "pr50k3", "ppl2_wend", "ppl_wfull", "ppl_wend",
                 "ppl_zfull", "ppl_zend"),
        notes="LPIPS-VGG16 distance for PPL + the PR feature space; "
              "metrics/vgg16.py imports torchvision or TorchScript naming.",
    ),
}


def _search_dirs():
    env = os.environ.get("PASTA_GAN_DETECTORS", "")
    dirs = [d for d in env.split(os.pathsep) if d]
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    dirs.append(os.path.join(repo_root, "weights"))
    dirs.append(os.path.expanduser("~/.cache/pasta_gan_tpu/detectors"))
    return dirs


def find_detector(name: str) -> Optional[str]:
    """Path of a locally-available detector file, or None."""
    spec = DETECTORS[name]
    for d in _search_dirs():
        for fn in spec["filenames"]:
            p = os.path.join(d, fn)
            if os.path.exists(p):
                return p
    return None


def verify_detector(name: str, path: str) -> str:
    """sha256 the file; warn-or-pass against the manifest pin.

    Returns the computed digest (callers print it so a verified download can
    be pinned into DETECTORS[name]['sha256'])."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    digest = h.hexdigest()
    pinned = DETECTORS[name]["sha256"]
    if pinned is not None and digest != pinned:
        raise ValueError(
            f"{path}: sha256 {digest} != manifest pin {pinned} for {name}"
        )
    return digest
