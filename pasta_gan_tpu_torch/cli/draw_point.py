"""Keypoint / stickman overlay for routing and geometry debugging
(counterpart of `pasta_gan_tpu/cli/draw_point.py`; the reference's
`draw_point.py` scratchpad), with its image I/O through `data/image_io.py`.

    python -m pasta_gan_tpu_torch.cli.draw_point --image person.jpg \\
        --keypoints person_keypoints.json --out overlay.png
"""

from __future__ import annotations

import argparse

import numpy as np

from ..data import image_io, stickman


def overlay_keypoints(image: np.ndarray, keypoints: np.ndarray, radius: int = 3, alpha: float = 0.6) -> np.ndarray:
    """Blend the stickman and its joints over an RGB uint8 image."""
    pose = stickman.draw_pose_from_cords(keypoints, image.shape[:2], radius=radius).astype(np.float32)
    mask = (pose.sum(-1, keepdims=True) > 0).astype(np.float32)
    out = image.astype(np.float32) * (1 - alpha * mask) + pose * alpha * mask
    return np.clip(out, 0, 255).astype(np.uint8)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--image", required=True)
    p.add_argument("--keypoints", required=True, help="OpenPose-style json")
    p.add_argument("--out", required=True, help="the overlay, a PNG file")
    p.add_argument("--radius", type=int, default=3)
    args = p.parse_args(argv)

    out = overlay_keypoints(image_io.read_rgb(args.image), stickman.load_keypoints(args.keypoints),
                            radius=args.radius)
    image_io.write_png(out, args.out)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
