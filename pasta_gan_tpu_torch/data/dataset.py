"""Host samples and the device-side try-on and training batches.

Counterpart of `pasta_gan_tpu/data/dataset.py`: host code builds per-sample
numpy dicts (image, stickman, keypoints, parsing masks); `prepare_tryon_batch`
and `prepare_train_batch` move a collated batch to the device and run the
patch routing there; `prepare_tryon_batch_v18` builds the released-256
checkpoint's batch, `prepare_tryon_batch_512` the 512x320 checkpoint's
region-selectable batch and `prepare_tryon_grid_batch` the training
snapshot's cross-pair batch.  The try-on batches take the routes' `denorm`
argument ("fused" or "separate", data/warp.py).

Host side: `load_sample` decodes one UPT person record (JPEG image, OpenPose
JSON, parsing PNG) with the port's own decoders (`data/image_io.py`, no PIL);
`UvitonDatasetFull` walks the four 256x192 training lists,
`UvitonDataset256Test` the unpaired 256 test pairs and `UvitonDataset512Test`
the 512x320 ones; `SyntheticUvitonDataset` draws a fixture without files.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from . import image_io
from . import masks as masks_mod
from . import stickman
from .warp import (
    CHANGE_REGIONS,
    route_patches_512_batch,
    route_patches_batch,
    route_patches_mix_batch,
    route_patches_transfer_batch,
    route_patches_v19_batch,
    transfer_warp_inputs,
    v19_warp_inputs,
    warp_inputs_512,
)


def pad_to_square(img: np.ndarray, value: int) -> tuple[np.ndarray, int]:
    """White-pad 256x192 -> 256x256. Returns (padded, left_padding)."""
    h, w = img.shape[:2]
    left = (h - w) // 2
    right = h - w - left
    if img.ndim == 2:
        img = img[..., None]
    out = np.pad(img, ((0, 0), (left, right), (0, 0)), constant_values=value)
    return out, left


def host_sample(image: np.ndarray, keypoints: np.ndarray, parsing: np.ndarray,
                size: tuple[int, int] = (256, 192)) -> Dict[str, np.ndarray]:
    """The host sample dict of `pasta_gan_tpu/data/dataset.py:load_sample`
    from an unpadded person: image [H, W, 3] uint8, keypoints [18, 3] and
    parsing labels [H, W].  The white-padded image, the stickman drawn on the
    unpadded `size` (H, W) frame then zero-padded, the UNPADDED keypoints
    (routing adds the pad) with `left_padding`, and the parsing masks built
    from the padded keypoints and parsing."""
    image, left = pad_to_square(image, 255)
    pose, _ = pad_to_square(stickman.draw_pose_from_cords(keypoints, size), 0)
    parsing, _ = pad_to_square(parsing.astype(np.uint8), 0)
    kps_padded = keypoints.copy()
    kps_padded[:, 0] += left
    m = masks_mod.build_sample_masks(kps_padded, parsing)
    return dict(
        image=image.astype(np.uint8),
        pose=pose.astype(np.uint8),
        keypoints=keypoints.astype(np.float32),
        retain_mask=m["retain"].astype(np.uint8),
        upper_mask=m["upper"].astype(np.uint8),
        lower_mask=m["lower"].astype(np.uint8),
        lower_test_mask=m["lower_test"].astype(np.uint8),
        gt_parsing=m["gt_parsing"][..., 0].astype(np.uint8),
        left_padding=np.int32(left),
    )


def load_sample(image_path: str, keypoints_path: str, parsing_path: str,
                size: tuple[int, int] = (256, 192)) -> Dict[str, np.ndarray]:
    """Decode one person record (`host_sample` of its JPEG, OpenPose JSON and
    parsing PNG, the parsing's first channel where it has several)."""
    parsing = image_io.read_image(parsing_path)
    if parsing.ndim == 3:
        parsing = parsing[..., 0]
    return host_sample(image_io.read_rgb(image_path), stickman.load_keypoints(keypoints_path), parsing, size)


def record_paths(root: str, ds: str, person: str, parsing_suffix: str = "_label.png"):
    """(image, keypoints, parsing) paths of `person` ("<name>.jpg") under root/ds."""
    base = os.path.join(root, ds)
    return (os.path.join(base, "image", person),
            os.path.join(base, "keypoints", person.replace(".jpg", "_keypoints.json")),
            os.path.join(base, "parsing", person.replace(".jpg", parsing_suffix)))


class UvitonDatasetFull:
    """Training records of the UPT 256x192 layout: the persons of
    {Zalando,Zalora,Deepfashion,MPV}_256_192/train_pairs_front_list_0508.txt
    (MPV's parsing files end in ".png", the others' in "_label.png"), each with
    an ACGPN erasure mask from train_random_mask_acgpn/ (sorted names, sample
    `idx % count`, grey, resized to 256x256, > 0; zeros when the folder is
    absent).  `random_seed` is the JAX dataset's argument; no draw uses it."""

    DATASETS = ["Zalando_256_192", "Zalora_256_192", "Deepfashion_256_192", "MPV_256_192"]

    def __init__(self, path: str, max_size: Optional[int] = None, random_seed: int = 0):
        self._records: List[tuple] = []
        for ds in self.DATASETS:
            txt = os.path.join(path, ds, "train_pairs_front_list_0508.txt")
            if not os.path.exists(txt):
                continue
            suffix = ".png" if ds == "MPV_256_192" else "_label.png"
            with open(txt) as f:
                self._records += [record_paths(path, ds, line.strip().split()[0], suffix) for line in f if line.strip()]
        if not self._records:
            raise IOError(f"no training records found under {path}")
        if max_size is not None:
            self._records = self._records[:max_size]
        acgpn_dir = os.path.join(path, "train_random_mask_acgpn")
        self._acgpn_fnames = (sorted(os.path.join(acgpn_dir, f) for f in os.listdir(acgpn_dir))
                              if os.path.isdir(acgpn_dir) else [])

    def __len__(self):
        return len(self._records)

    def _load_acgpn_mask(self, idx: int) -> np.ndarray:
        if not self._acgpn_fnames:
            return np.zeros((256, 256, 1), np.uint8)
        m = image_io.read_l_resized(self._acgpn_fnames[idx % len(self._acgpn_fnames)], (256, 256))
        return (m[..., None] > 0).astype(np.uint8)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        sample = load_sample(*self._records[idx])
        sample["acgpn_mask"] = self._load_acgpn_mask(idx)
        return sample


class UvitonDataset256Test:
    """Unpaired 256 test pairs: person/garment records named by
    UPT_subset{1,2}_256_192/test_pairs_front_list_shuffle_0508.txt."""

    SUBSETS = ["UPT_subset1_256_192", "UPT_subset2_256_192"]
    SIZE = (256, 192)  # the records' unpadded frame (H, W)

    def __init__(self, path: str, max_size: Optional[int] = None):
        self._path = path
        self._pairs: List[tuple] = []
        for ds in self.SUBSETS:
            txt = os.path.join(path, ds, "test_pairs_front_list_shuffle_0508.txt")
            if not os.path.exists(txt):
                continue
            with open(txt) as f:
                self._pairs += [(ds, *parts[:2]) for parts in (line.strip().split() for line in f) if len(parts) >= 2]
        if not self._pairs:
            raise IOError(f"no {self.SIZE[0]} test pairs found under {path}")
        if max_size is not None:
            self._pairs = self._pairs[:max_size]

    def __len__(self):
        return len(self._pairs)

    def __getitem__(self, idx: int):
        ds, person, garment = self._pairs[idx]
        return dict(person=load_sample(*record_paths(self._path, ds, person), size=self.SIZE),
                    garment=load_sample(*record_paths(self._path, ds, garment), size=self.SIZE),
                    person_name=person, garment_name=garment)


class UvitonDataset512Test(UvitonDataset256Test):
    """Unpaired 512x320 test pairs: person/garment records named by
    UPT_subset{1,2}_512_320/test_pairs_front_list_shuffle_0508.txt, loaded
    at (512, 320) and white-padded to 512x512 (left padding 96).
    `change_region` ("fullbody", "upperbody" or "lowerbody") picks which
    garment pieces route; each item carries it."""

    SUBSETS = ["UPT_subset1_512_320", "UPT_subset2_512_320"]
    SIZE = (512, 320)

    def __init__(self, path: str, change_region: str = "fullbody", max_size: Optional[int] = None):
        if change_region not in CHANGE_REGIONS:
            raise ValueError(f"change_region must be one of {CHANGE_REGIONS}, got {change_region!r}")
        super().__init__(path, max_size)
        self.change_region = change_region

    def __getitem__(self, idx: int):
        return dict(super().__getitem__(idx), change_region=self.change_region)


class SyntheticUvitonDataset:
    """Deterministic synthetic person fixture: plausible keypoints and simple
    parsing geometry (the JAX package's fixture)."""

    BASE_KPS = {
        0: (96, 40), 1: (96, 70), 2: (70, 72), 3: (60, 105), 4: (56, 140),
        5: (122, 72), 6: (132, 105), 7: (136, 140), 8: (78, 140), 9: (74, 190),
        10: (72, 235), 11: (114, 140), 12: (118, 190), 13: (120, 235),
        14: (90, 34), 15: (102, 34), 16: (84, 38), 17: (108, 38),
    }

    def __init__(self, num_samples: int = 8, resolution: int = 256, seed: int = 0):
        self.n = num_samples
        self.res = resolution
        self.seed = seed
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}  # drawing is slow host numpy work; draw once

    def __len__(self):
        return self.n

    def _keypoints(self, rng) -> np.ndarray:
        kps = np.zeros((18, 3), np.float32)
        for i, (x, y) in self.BASE_KPS.items():
            kps[i] = (x + rng.normal(0, 4), y + rng.normal(0, 4), 0.9)
        return kps

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if idx not in self._cache:
            self._cache[idx] = self._draw(idx)
        return self._cache[idx]

    def _draw(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        kps = self._keypoints(rng)
        parsing = np.zeros((256, 192), np.uint8)

        def rect(x0, y0, x1, y1, label):
            parsing[max(0, int(y0)) : int(y1), max(0, int(x0)) : int(x1)] = label

        # head circle (13), torso garment (5), pants (9), arms (14/15),
        # legs (16/17), shoes (18/19)
        cx, cy = int(kps[0][0]), int(kps[0][1])
        yy, xx = np.ogrid[:256, :192]
        parsing[(yy - cy) ** 2 + (xx - cx) ** 2 < 18**2] = 13
        rect(kps[2][0], kps[2][1], kps[5][0], kps[8][1], 5)
        rect(kps[8][0] - 8, kps[8][1], kps[11][0] + 8, kps[9][1] + 20, 9)
        rect(kps[3][0] - 6, kps[3][1] - 10, kps[3][0] + 6, kps[4][1], 15)
        rect(kps[6][0] - 6, kps[6][1] - 10, kps[6][0] + 6, kps[7][1], 14)
        rect(kps[9][0] - 7, kps[9][1] + 20, kps[9][0] + 7, kps[10][1], 16)
        rect(kps[12][0] - 7, kps[12][1] + 20, kps[12][0] + 7, kps[13][1], 17)
        rect(kps[10][0] - 8, kps[10][1], kps[10][0] + 8, 255, 18)
        rect(kps[13][0] - 8, kps[13][1], kps[13][0] + 8, 255, 19)

        colors = rng.integers(40, 215, (20, 3))
        image = np.full((256, 192, 3), 255, np.uint8)
        for label in range(1, 20):
            image[parsing == label] = colors[label % 20]
        image = np.clip(image.astype(np.int32) + rng.integers(-12, 12, image.shape), 0, 255).astype(np.uint8)

        sample = host_sample(image, kps, parsing)
        sample["acgpn_mask"] = np.zeros((256, 256, 1), np.uint8)
        return sample


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _f32(d, k, dev):
    return torch.as_tensor(d[k], device=dev).float()


def _tryon_sources(person, garment, dev):
    """The unpaired try-on route's arguments: the garment's upper clothes and
    the person's own lower clothes (the 256 test path's lower grouping where
    the sample has it), then the two keypoint sets."""
    p_img = _f32(person, "image", dev) / 255.0
    g_img = _f32(garment, "image", dev) / 255.0
    p_lower_mask = _f32(person, "lower_test_mask" if "lower_test_mask" in person else "lower_mask", dev)
    g_upper_mask = _f32(garment, "upper_mask", dev)
    return (g_img * g_upper_mask, p_img * p_lower_mask, g_upper_mask, p_lower_mask,
            _f32(garment, "keypoints", dev), _f32(person, "keypoints", dev))


def _person_conditioning(person, dev):
    """(person image in [-1, 1], retain image, 6-channel pose) of a collated
    person batch: the stickman in [-1, 1] beside the retain regions."""
    p_real = _f32(person, "image", dev) / 255.0 * 2.0 - 1.0
    p_retain = _f32(person, "retain_mask", dev)
    retain = p_retain * p_real - (1.0 - p_retain)
    return p_real, retain, torch.cat([_f32(person, "pose", dev) / 127.5 - 1.0, retain], dim=-1)


def _tryon_batch(routed, person, dev) -> Dict[str, torch.Tensor]:
    """The generator's try-on inputs from a route's output and the person
    batch: a style input of the norm patches, the retain image, the pose,
    and the denorms in [-1, 1] with their coverage masks."""
    p_real, retain, pose = _person_conditioning(person, dev)
    return {
        "style_input": torch.cat([routed.norm_img, routed.norm_img_lower], dim=-1) * 2.0 - 1.0,
        "retain": retain,
        "pose": pose,
        "denorm_upper_img": routed.denorm_upper_img * 2.0 - 1.0,
        "denorm_lower_img": routed.denorm_lower_img * 2.0 - 1.0,
        "denorm_upper_mask": (routed.denorm_upper_img.sum(-1, keepdim=True) > 0).float(),
        "denorm_lower_mask": (routed.denorm_lower_img.sum(-1, keepdim=True) > 0).float(),
        "person_img": p_real,
    }


def tryon_warp_inputs(person, garment, box_factor: int = 2, device="cuda") -> dict:
    """The routing kernels' operands for a collated try-on batch (what
    `prepare_tryon_batch` feeds them)."""
    return transfer_warp_inputs(*_tryon_sources(person, garment, resolve_device(device)), box_factor=box_factor)


def prepare_tryon_batch(person, garment, box_factor: int = 2, device="cuda",
                        denorm: str = "fused") -> Dict[str, torch.Tensor]:
    """Unpaired try-on batch: garment patches re-projected into the person's
    pose, the person keeping only its retain regions.  `person`/`garment` are
    collated host dicts (numpy or tensors); returns float32 NHWC tensors on
    `device` with the JAX package's keys and shapes."""
    dev = resolve_device(device)
    routed = route_patches_transfer_batch(*_tryon_sources(person, garment, dev), box_factor=box_factor,
                                          denorm=denorm)
    return _tryon_batch(routed, person, dev)


def _tryon_sources_v18(person, garment, dev):
    p_img = _f32(person, "image", dev) / 255.0
    g_img = _f32(garment, "image", dev) / 255.0
    p_pose = _f32(person, "pose", dev) / 255.0  # the released checkpoint's stickman is in [0, 1]
    g_upper_mask = _f32(garment, "upper_mask", dev)
    p_lower_mask = _f32(person, "lower_test_mask" if "lower_test_mask" in person else "lower_mask", dev)
    routing_args = (
        g_img * g_upper_mask, g_upper_mask, _f32(garment, "pose", dev) / 255.0,
        p_img * p_lower_mask, p_lower_mask, p_pose,
        _f32(garment, "keypoints", dev), _f32(person, "keypoints", dev),
    )
    return p_img, p_pose, _f32(person, "retain_mask", dev), routing_args


def tryon_warp_inputs_v18(person, garment, box_factor: int = 2, device="cuda") -> dict:
    """The routing kernels' operands for a collated released-256 batch (what
    `prepare_tryon_batch_v18` feeds them)."""
    _, _, _, routing_args = _tryon_sources_v18(person, garment, resolve_device(device))
    return v19_warp_inputs(*routing_args, box_factor=box_factor)


def prepare_tryon_batch_v18(person, garment, box_factor: int = 2, device="cuda",
                            denorm: str = "fused") -> Dict[str, torch.Tensor]:
    """The released-256 checkpoint's batch (`pasta_gan_tpu/data/dataset.py:
    prepare_tryon_batch_v18`): a 60-channel style input (the 10 norm image
    patches and the 10 norm stickman patches), the retain image, a 6-channel
    pose (stickman and retain) and the denorms re-projected into the person's
    pose with eroded upper masks.  Float32 NHWC tensors on `device`."""
    p_img, p_pose, p_retain, routing_args = _tryon_sources_v18(person, garment, resolve_device(device))
    routed = route_patches_v19_batch(*routing_args, box_factor=box_factor, denorm=denorm)
    p_real = p_img * 2.0 - 1.0
    retain = p_retain * p_real - (1.0 - p_retain)
    return {
        "style_input": torch.cat([routed.norm_img, routed.norm_pose], dim=-1) * 2.0 - 1.0,
        "retain": retain,
        "pose": torch.cat([p_pose * 2.0 - 1.0, retain], dim=-1),
        "denorm_upper_img": routed.denorm_upper_img * 2.0 - 1.0,
        "denorm_lower_img": routed.denorm_lower_img * 2.0 - 1.0,
        "denorm_upper_mask": (routed.denorm_upper_img.sum(-1, keepdim=True) > 0).float(),
        "denorm_lower_mask": (routed.denorm_lower_img.sum(-1, keepdim=True) > 0).float(),
        "person_img": p_real,
    }


def _region_sources(person, garment, dev):
    """The eight image and mask sources of the 512 and grid routes: each
    sample's upper and lower clothes cut out by its `upper_mask` /
    `lower_mask`, then the two keypoint sets."""
    out = []
    for d in (person, garment):
        img = _f32(d, "image", dev) / 255.0
        up, lo = _f32(d, "upper_mask", dev), _f32(d, "lower_mask", dev)
        out.append((img * up, img * lo, up, lo))
    return (*out[0], *out[1], _f32(person, "keypoints", dev), _f32(garment, "keypoints", dev))


def warp_inputs_512_batch(person, garment, change_region: str = "fullbody", box_factor: int = 2,
                          pad_x: float = 96.0, device="cuda") -> dict:
    """The routing kernels' operands for a collated 512 batch (what
    `prepare_tryon_batch_512` feeds them)."""
    dev = resolve_device(device)
    return warp_inputs_512(*_region_sources(person, garment, dev), change_region=change_region,
                           box_factor=box_factor, pad_x=pad_x)


def prepare_tryon_batch_512(person, garment, change_region: str = "fullbody", box_factor: int = 2,
                            pad_x: float = 96.0, device="cuda", denorm: str = "fused") -> Dict[str, torch.Tensor]:
    """The 512x320 checkpoint's region-selectable batch
    (`pasta_gan_tpu/data/dataset.py:prepare_tryon_batch_512`): a 45-channel
    style input (the 10 norm patches of the region's upper source and the 5
    of its lower source), the retain image, a 6-channel pose and the denorms
    re-projected into the person's pose with every mask eroded.  The cut-outs
    use the plain `upper_mask` / `lower_mask` groups; `pad_x` is the samples'
    left padding (96 at 512x320).  Float32 NHWC tensors on `device`."""
    dev = resolve_device(device)
    routed = route_patches_512_batch(*_region_sources(person, garment, dev), change_region=change_region,
                                     box_factor=box_factor, pad_x=pad_x, denorm=denorm)
    return _tryon_batch(routed, person, dev)


def prepare_tryon_grid_batch(person, garment, swap: str = "upper", box_factor: int = 2,
                             device="cuda") -> Dict[str, torch.Tensor]:
    """The training snapshot's cross-pair batch
    (`pasta_gan_tpu/data/dataset.py:prepare_tryon_grid_batch`): the person's
    body wearing the garment provider's top ("upper"), pants ("lower") or
    both ("full"), from training-path samples.  The try-on batch's keys,
    float32 NHWC tensors on `device`."""
    dev = resolve_device(device)
    routed = route_patches_mix_batch(*_region_sources(person, garment, dev), swap=swap, box_factor=box_factor)
    return _tryon_batch(routed, person, dev)


def erasure_draws(batch_size: int, generator: Optional[torch.Generator] = None):
    """The three uniform draws of the random erasure, [B,1,1,1], [B,4,1,1,1]
    and [B,1,1,1], from `generator` (a CPU generator)."""
    B = batch_size
    return (torch.rand((B, 1, 1, 1), generator=generator), torch.rand((B, 4, 1, 1, 1), generator=generator),
            torch.rand((B, 1, 1, 1), generator=generator))


def prepare_train_batch(host_batch, generator: Optional[torch.Generator] = None, box_factor: int = 2,
                        device="cuda", draws=None) -> Dict[str, torch.Tensor]:
    """Collated host samples -> the train-step batch, the heavy work on `device`.

    Normalization to [-1, 1], patch self-routing, the random hand / ACGPN
    erasure of the denormalized garments (hand masks kept with p 0.4, then
    each with p 0.5; the ACGPN mask with p 0.9), the 6-channel pose + head
    conditioning and the 42-channel style input.  The erasure's uniform draws
    come from `generator`, or are passed as `draws` (see `erasure_draws`).
    Float32 NHWC tensors, `gt_parsing` int64 [B, H, W]."""
    dev = resolve_device(device)

    def f32(k):
        return torch.as_tensor(host_batch[k], device=dev).float()

    image = f32("image") / 255.0  # [B, 256, 256, 3] in [0, 1]
    upper_mask, lower_mask = f32("upper_mask"), f32("lower_mask")
    routed = route_patches_batch(image * upper_mask, image * lower_mask, upper_mask, lower_mask, f32("keypoints"),
                                 box_factor=box_factor)

    u_hands, u_sel, u_acgpn = (torch.as_tensor(d, device=dev).float()
                               for d in (draws if draws is not None else erasure_draws(image.shape[0], generator)))
    use_hands = (u_hands < 0.4).float()
    hand_sel = (u_sel < 0.5).float()
    hand_mask = (routed.denorm_hand_masks * hand_sel).sum(dim=1) * use_hands
    use_acgpn = (u_acgpn < 0.9).float()
    erase = ((hand_mask + f32("acgpn_mask") * use_acgpn) > 0).float()

    denorm_upper = routed.denorm_upper_img * (1.0 - erase)
    denorm_lower = routed.denorm_lower_img * (1.0 - erase)
    real = image * 2.0 - 1.0
    retain = f32("retain_mask")
    head = retain * real - (1.0 - retain)
    pose = f32("pose") / 127.5 - 1.0
    return {
        "real_img": real,
        "style_input": torch.cat([routed.norm_img, routed.norm_img_lower], dim=-1) * 2.0 - 1.0,
        "retain": head,
        "pose": torch.cat([pose, head], dim=-1),
        "denorm_upper_img": denorm_upper * 2.0 - 1.0,
        "denorm_lower_img": denorm_lower * 2.0 - 1.0,
        "denorm_upper_mask": (denorm_upper.sum(-1, keepdim=True) > 0).float(),
        "denorm_lower_mask": (denorm_lower.sum(-1, keepdim=True) > 0).float(),
        "gt_parsing": torch.as_tensor(host_batch["gt_parsing"], device=dev).long(),
    }
