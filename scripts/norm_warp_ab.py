#!/usr/bin/env python3
"""Old-against-new timing of the port's `norm_warp` CUDA kernel on one NVIDIA GPU.

    python3 scripts/norm_warp_ab.py --old DIR [--variants JSON] [--files DIR/a.cu ...]
    python3 scripts/norm_warp_ab.py --model       # CPU only: cache lines per warp gather

DIR holds an earlier `norm_warp.cu` with the headers it includes (for
example `git archive <rev> pasta_gan_tpu_torch/csrc` unpacked under the
gitignored `_archive/`).  Each source (the earlier one, the checkout's
`pasta_gan_tpu_torch/csrc/norm_warp.cu`, each `--variants` entry: a name and
[find, replace] pairs applied to the checkout's source, and each `--files`
source) is built with nvcc and the package's flags into its own library and
called through the C entry point `pasta_norm_warp_f32` at four route shapes:
the Full try-on route at batch 16 (C = 4), the released-256 route at batch 16
(C = 8), the training step's self route at batch 32 (C = 4) and the Full
route at batch 1.  Every build is held to `norm_warp_reference` bit for bit
(names starting with "diag" are diagnostics and are not), then timed with
`chip_smoke.cuda_time_ms` (L2 flushed by a 256 MB write before each launch,
mean and median of 20) in turns old, new, variants..., variants..., new, old,
beside a memset of the same output and the byte bound.  Also printed: each
build's registers, the spread of 60 launches with and without a device-side
wait after the flush (at the Full batch-16 shape), the time of 50 launches
back to back without a flush ("warm"), and the time after a flush that
leaves the L2 clean (a 256 MB read) instead of dirty.

`--model` counts, on the CPU, the distinct 128-byte lines and 32-byte
sectors that one warp's gather of one tap touches when its 32 lanes take 32
pixels of a row, or a 16x2, 8x4 or 4x8 tile, on the two batch-16 routes.
"""

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def route_inputs(torch, device):
    """(label, norm_warp operands) of the four shapes."""
    from pasta_gan_tpu_torch.data.dataset import (
        SyntheticUvitonDataset, collate, tryon_warp_inputs, tryon_warp_inputs_v18,
    )
    from pasta_gan_tpu_torch.data.warp import self_warp_inputs

    ds = SyntheticUvitonDataset(num_samples=16)
    p16 = collate([ds[i] for i in range(16)])
    g16 = collate([ds[(i + 1) % 16] for i in range(16)])
    yield "Full b16 C=4", tryon_warp_inputs(p16, g16, device=device)
    yield "V18 b16 C=8", tryon_warp_inputs_v18(p16, g16, device=device)
    train = collate([SyntheticUvitonDataset(num_samples=64, seed=0)[i] for i in range(32)])

    def f32(k):
        return torch.as_tensor(train[k], device=device).float()

    image = f32("image") / 255.0
    um, lm = f32("upper_mask"), f32("lower_mask")
    yield "train b32 C=4", self_warp_inputs(image * um, image * lm, um, lm, f32("keypoints"))
    yield "Full b1 C=4", tryon_warp_inputs(collate([ds[0]]), collate([ds[1]]), device=device)


def lines_model():
    import torch

    from pasta_gan_tpu_torch.ops.warp_math import warp_coords

    for label, r in route_inputs(torch, "cpu"):
        if "b16" not in label:
            break
        B, H, W, C = r["src_u"].shape
        N = r["minv_norm"].shape[1]
        h, w = r["patch_hw"]
        sx, sy = warp_coords(r["minv_norm"], (h, w))
        sx, sy = sx.clamp(0, W - 1), sy.clamp(0, H - 1)
        xi, yi = sx.floor().long(), sy.floor().long()
        xj, yj = (xi + 1).clamp(max=W - 1), (yi + 1).clamp(max=H - 1)
        valid = r["valid_norm"] != 0
        for tw, th in ((32, 1), (16, 2), (8, 4), (4, 8)):
            lines = sectors = count = 0
            for yy, xx in ((yi, xi), (yi, xj), (yj, xi), (yj, xj)):
                byte = (yy * W + xx) * C * 4  # [B, N, h, w]
                t = byte.reshape(B, N, h // th, th, w // tw, tw).permute(0, 1, 2, 4, 3, 5).reshape(B, N, -1, tw * th)
                t = t[valid].reshape(-1, tw * th)
                for g in range(C // 4):
                    a = t + 16 * g
                    for unit, acc in ((128, "lines"), (32, "sectors")):
                        s = torch.sort(a // unit, dim=1).values
                        n = int((1 + (s[:, 1:] != s[:, :-1]).sum(1)).sum())
                        if acc == "lines":
                            lines += n
                        else:
                            sectors += n
                    count += a.shape[0]
            print(f"{label}: warp of {tw}x{th} pixels: {count} warp gathers, {lines / count:.2f} lines and "
                  f"{sectors / count:.2f} sectors per gather", flush=True)


def build(nvcc, flags, sources):
    """{name: ctypes function} of each (name, directory with norm_warp.cu)."""
    procs = {n: subprocess.Popen([nvcc, *flags, "-o", os.path.join(d, "lib.so"), os.path.join(d, "norm_warp.cu")],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for n, d in sources.items()}
    fns = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {n}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {n}: {line.strip()}", flush=True)
        fn = ctypes.CDLL(os.path.join(sources[n], "lib.so")).pasta_norm_warp_f32
        fns[n] = fn
    return fns


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", help="directory with the earlier norm_warp.cu and its headers")
    ap.add_argument("--variants", default="{}", help="JSON {name: [[find, replace], ...]} on the checkout's source")
    ap.add_argument("--files", nargs="*", default=[], help="further norm_warp.cu sources, named by file")
    ap.add_argument("--model", action="store_true", help="print the cache-line model on the CPU and stop")
    args = ap.parse_args()
    if args.model:
        return lines_model()

    import torch

    import chip_smoke as cs
    from pasta_gan_tpu_torch.ops import cuda_kernels as ck
    from pasta_gan_tpu_torch.ops import warp_kernels as wk

    if not torch.cuda.is_available() or not args.old:
        raise SystemExit("needs an NVIDIA GPU and --old")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = cs.card_tag()
    print(f"card: {tag}", flush=True)
    with tempfile.TemporaryDirectory(prefix="norm_warp_ab_") as work:
        compare(torch, cs, ck, wk, tag, work, args)


def compare(torch, cs, ck, wk, tag, work, args):
    """Build every source under `work`, check and time it at the four shapes."""
    new_src = open(os.path.join(ck.CSRC_DIR, "norm_warp.cu")).read()

    def source_dir(name, text, headers):
        d = os.path.join(work, name)
        os.makedirs(d)
        for f in os.listdir(headers):
            if f.endswith(".cuh"):
                shutil.copy(os.path.join(headers, f), d)
        with open(os.path.join(d, "norm_warp.cu"), "w") as f:
            f.write(text)
        return d

    sources = {"old": source_dir("old", open(os.path.join(args.old, "norm_warp.cu")).read(), args.old),
               "new": source_dir("new", new_src, ck.CSRC_DIR)}
    for name, subs in json.loads(args.variants).items():
        text = new_src
        for a, b in subs:
            if a not in text:
                raise SystemExit(f"variant {name}: {a!r} is not in the source")
            text = text.replace(a, b)
        sources[name] = source_dir(name, text, ck.CSRC_DIR)
    for path in args.files:
        sources[os.path.splitext(os.path.basename(path))[0]] = source_dir(
            os.path.splitext(os.path.basename(path))[0], open(path).read(), ck.CSRC_DIR)
    fns = build(ck._nvcc(), ck.NVCC_FLAGS, sources)
    for fn in fns.values():
        fn.argtypes = ck.NORM_WARP.argtypes
        fn.restype = ctypes.c_int

    def entry(fn, args_):
        src0, src1, minv, valid, n0, (h, w) = args_
        B, H, W, C = src0.shape
        N = minv.shape[1]
        out = torch.empty((B, N, C, h, w), device="cuda")
        stream = ck.stream_of(src0.device)

        def launch():
            rc = fn(src0.data_ptr(), src1.data_ptr(), minv.data_ptr(), valid.data_ptr(), out.data_ptr(),
                    B, N, n0, H, W, h, w, C, stream)
            if rc:
                raise RuntimeError(f"launch failed with CUDA error {rc}")
        return launch, out

    def spread(fn, guard, iters=60):
        scratch = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
        for _ in range(3):
            fn()
        ts = []
        for _ in range(iters):
            scratch.zero_()
            if guard:
                torch.cuda._sleep(300000)  # the launch is queued before the start event
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            ts.append(s.elapsed_time(e))
        ts.sort()
        return (f"mean {sum(ts) / iters:.4f}, median {statistics.median(ts):.4f}, p10 {ts[iters // 10]:.4f}, "
                f"p90 {ts[9 * iters // 10]:.4f}, max {ts[-1]:.4f}")

    def warm(fn, iters=50):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / iters

    def clean(fn, iters=20):
        scratch = torch.ones(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
        ts = []
        for _ in range(iters + 3):
            scratch.sum()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            ts.append(s.elapsed_time(e))
        ts = ts[3:]
        return sum(ts) / iters, statistics.median(ts)

    others = [n for n in fns if n != "old"]
    order = ["old"] + others + others[::-1] + ["old"]
    summary = {}
    for label, r in route_inputs(torch, "cuda"):
        args_ = (r["src_u"], r["src_l"], r["minv_norm"], r["valid_norm"], r["n_upper"], r["patch_hw"])
        ref = wk.norm_warp_reference(*args_)
        launches = {}
        for n, fn in fns.items():
            launch, out = entry(fn, args_)
            launch()
            torch.cuda.synchronize()
            if not (n.startswith("diag") or torch.equal(out, ref)):
                raise SystemExit(f"{n} differs from the plain version at {label}")
            launches[n] = (launch, out)
        times = {n: [] for n in fns}
        for n in order:
            times[n].append(cs.cuda_time_ms(torch, launches[n][0]))
        out = launches["new"][1]
        memset = cs.cuda_time_ms(torch, out.zero_)
        src_bytes = cs.norm_source_bytes(torch, r)
        byts = src_bytes + cs.nbytes(r["minv_norm"], r["valid_norm"], out)
        bound = byts / cs.PEAK_BYTES_PER_S * 1e3
        print(f"== {label} {list(out.shape)}: bound {bound:.4f} ms ({byts / 1e6:.2f} MB, source sectors "
              f"{src_bytes / 1e6:.2f}); memset of the output {memset[0]:.4f} (median {memset[1]:.4f}) [{tag}]",
              flush=True)
        for n in fns:
            means = [m for m, _ in times[n]]
            medians = [m for _, m in times[n]]
            mean = sum(means) / len(means)
            print(f"   {n:12s} mean {' / '.join(f'{m:.4f}' for m in means)}  median "
                  f"{' / '.join(f'{m:.4f}' for m in medians)} -> {mean:.4f} ({bound / mean:.0%} of the bound); "
                  f"warm {warm(launches[n][0]):.4f}", flush=True)
        c_old, c_new, c_memset = clean(launches["old"][0]), clean(launches["new"][0]), clean(out.zero_)
        print(f"   clean L2: old {c_old[0]:.4f} ({c_old[1]:.4f}), new {c_new[0]:.4f} ({c_new[1]:.4f}), memset "
              f"{c_memset[0]:.4f} ({c_memset[1]:.4f})", flush=True)
        if label.startswith("Full b16"):
            for n in ("old", "new"):
                for guard in (False, True):
                    print(f"   spread {n} {'with a device-side wait' if guard else 'plain'}: "
                          f"{spread(launches[n][0], guard)}", flush=True)
        summary[label] = {n: sum(m for m, _ in times[n]) / len(times[n]) for n in fns}
    print(json.dumps({"norm_warp_ab_ms": summary, "card": tag}), flush=True)


if __name__ == "__main__":
    main()
