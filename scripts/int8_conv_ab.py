#!/usr/bin/env python3
"""Old-against-new timing of the port's int8 convolution path on one NVIDIA GPU.

    python3 scripts/int8_conv_ab.py --old DIR

DIR is the root of an earlier tree of this repository (for example `git
archive <rev>` unpacked under the gitignored `_archive/`).
* The convolution: the earlier `csrc/int8_conv.cu` is built with nvcc and
  the package's flags and called through the earlier `ops/quant.py`, the
  checkout's through its own, at the heaviest classes of a full-width Full
  forward and at the entry, merge and down-conv classes: each held to
  `int8_conv_reference` bit for bit, then timed with CUDA events (L2 flushed
  by a 256 MB write before each launch, median of 20) in turns old, new,
  new, old, through the C entry point (operands laid out beforehand) and
  through the wrapper the forward calls (the earlier `_int8_conv_kernel`,
  which lays out both operands on every call; the checkout's
  `int8_conv_packed` on the packed operands), with the int8 operations a
  second.
* The quantize pass at the forward's activation shapes: the earlier plain
  quantize followed by its NHWC layout copy, against `quantize_pack`, held
  equal and timed the same way.
* The forward: one batch-16 int8_static forward of a full-width
  GeneratorFull (bf16, seed 0, 16 synthetic pairs), each tree in a process
  of its own (`--forward TREE`), in turns old, new, new, old: host median of
  10 ended by a synchronise and the profiler's device ms, beside the
  checkout's bf16 float forward.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (N, C, O, k, H, W, stride, ((top, bottom), (left, right)), input dilation)
CASES = {
    "3x3 128->128 128x128 b16 (main)": (16, 128, 128, 3, 128, 128, 1, ((1, 1), (1, 1)), 1),
    "3x3 256->128 128x128 b16 (SPADE mlp)": (16, 256, 128, 3, 128, 128, 1, ((1, 1), (1, 1)), 1),
    "3x3 64->64 256x256 b32": (32, 64, 64, 3, 256, 256, 1, ((1, 1), (1, 1)), 1),
    "3x3 512->512 32x32 b16": (16, 512, 512, 3, 32, 32, 1, ((1, 1), (1, 1)), 1),
    "6x6 dil2 128->64 128->256 b16 (fold)": (16, 128, 64, 6, 128, 128, 1, ((3, 3), (3, 3)), 2),
    "7x7 3->64 256x256 b32 (entry)": (32, 3, 64, 7, 256, 256, 1, ((3, 3), (3, 3)), 1),
    "1x1 128->128 128x128 b16": (16, 128, 128, 1, 128, 128, 1, ((0, 0), (0, 0)), 1),
    "1x1 64->64 256x256 b32": (32, 64, 64, 1, 256, 256, 1, ((0, 0), (0, 0)), 1),
    "3x3 s2 64->128 257 b32 (down)": (32, 64, 128, 3, 257, 257, 2, ((0, 0), (0, 0)), 1),
}
# (N, C, H, W) of the quantize pass, bf16
QUANTIZE = [(16, 128, 128, 128), (16, 64, 256, 256), (32, 64, 257, 257), (16, 256, 128, 128), (16, 512, 32, 32),
            (32, 3, 256, 256)]


def load_old(torch, old_root):
    """The earlier wrapper module, bound to the earlier source's own library."""
    path = os.path.join(old_root, "pasta_gan_tpu_torch", "ops", "quant.py")
    src = open(path).read().replace(
        "from .cuda_kernels import INT8_CONV, check_tensor",
        "from pasta_gan_tpu_torch.ops.cuda_kernels import CudaKernel, check_tensor, INT8_CONV as _NEW\n"
        "INT8_CONV = CudaKernel('int8_conv_old', os.path.join(OLD_CSRC, 'int8_conv.cu'), 'pasta_int8_conv',"
        " _NEW.argtypes)")
    old = types.ModuleType("old_quant")
    old.__dict__.update(os=os, OLD_CSRC=os.path.join(os.path.abspath(old_root), "pasta_gan_tpu_torch", "csrc"))
    exec(compile(src, path, "exec"), old.__dict__)
    return old


def event_ms(torch, fn, iters=20):
    scratch = torch.empty(64 * 1024 * 1024, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        scratch.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def card_tag():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def forward(tree):
    """One tree's batch-16 Full int8_static forward: prints one JSON line."""
    sys.path.insert(0, tree)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pasta_gan_tpu_torch.cli import test as cli
    from pasta_gan_tpu_torch.data.dataset import SyntheticUvitonDataset, collate, prepare_tryon_batch
    from pasta_gan_tpu_torch.models import GeneratorFull
    from pasta_gan_tpu_torch.ops import cuda_kernels as ck

    assert os.path.abspath(ck.__file__).startswith(os.path.abspath(tree)), ck.__file__
    ck.build_kernels()
    gen = GeneratorFull().reset_parameters(torch.Generator().manual_seed(0)).cuda().eval().set_dtype(torch.bfloat16)
    ds = SyntheticUvitonDataset(num_samples=16)
    on_card = lambda d: {k: torch.as_tensor(v, device="cuda") for k, v in d.items()}  # noqa: E731
    person = on_card(collate([ds[i] for i in range(16)]))
    garment = on_card(collate([ds[(i + 1) % 16] for i in range(16)]))
    b = {k: v.to(torch.bfloat16) for k, v in prepare_tryon_batch(person, garment, device="cuda").items()}
    w_avg = torch.zeros(512, device="cuda")
    out = {}
    for mode in ("bf16", "int8_static"):
        if mode != "bf16":
            cli.calibrate_int8_static(gen, w_avg, [b])
        with torch.no_grad():
            fn = lambda: cli.tryon_forward(gen, w_avg, b)  # noqa: E731
            fn()
            torch.cuda.synchronize()
            times = []
            for _ in range(10):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
        dev = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 3e3
        out[mode] = dict(host_ms=statistics.median(times) * 1e3, device_ms=dev,
                         digest=float(fn().float().sum()))
    print("FORWARD " + json.dumps(out), flush=True)


def main():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--old", help="root of an earlier tree of this repository")
    p.add_argument("--forward", metavar="TREE", help="time one tree's forward (the script's own subprocess)")
    args = p.parse_args()
    if args.forward:
        return forward(args.forward)
    import torch

    sys.path.insert(0, ROOT)
    from pasta_gan_tpu_torch.ops import cuda_kernels as ck
    from pasta_gan_tpu_torch.ops import quant as tq

    if not torch.cuda.is_available() or not args.old:
        raise SystemExit("int8_conv_ab: needs an NVIDIA GPU and --old")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    F = torch.nn.functional
    old = load_old(torch, args.old)
    for k in (ck.INT8_CONV, old.INT8_CONV, ck.QUANTIZE_PACK):
        for line in ck.build_kernels([k]).get(k.source, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {k.name}: {line.strip()}", flush=True)
    tag = card_tag()
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, (N, C, O, k, H, W, stride, pads, dil) in CASES.items():
        xq = torch.randint(-127, 128, (N, C, H, W), generator=g, device="cuda", dtype=torch.int8)
        wq = torch.randint(-127, 128, (O, C, k, k), generator=g, device="cuda", dtype=torch.int8)
        sx, sw = torch.rand(N, 1, 1, 1, generator=g, device="cuda"), torch.rand(O, generator=g, device="cuda")
        a = (xq, wq, sx, sw, stride, pads, dil, torch.bfloat16)
        ref = tq.int8_conv_reference(*a)
        xa = tq.QuantizedActivation(F.pad(xq.permute(0, 2, 3, 1), (0, -C % 16)).contiguous(), sx, C)
        pw = tq.pack_int8_weight(wq, sw, stride, pads, dil)
        wrapper = {"old": lambda: old._int8_conv_kernel(*a), "new": lambda: tq.int8_conv_packed(xa, pw)}
        entry = {}
        for label, mod in (("old", old), ("new", tq)):
            ops, y = mod.kernel_operands(xq, wq, stride, pads, dil), torch.empty_like(ref)
            sxf = sx.reshape(-1).contiguous()
            entry[label] = lambda mod=mod, ops=ops, y=y, sxf=sxf: mod.launch_kernel(ops, sxf, sw, y) or y
            for fn in (wrapper[label], entry[label]):
                err = float((fn().float() - ref.float()).abs().max())
                assert err == 0, f"{name}: the {label} kernel differs from the plain version by {err}"
        ones = torch.ones(N, 1, H, W, dtype=torch.int8, device="cuda")
        taps = float(tq.int8_conv_reference(ones, torch.ones(1, 1, k, k, dtype=torch.int8, device="cuda"),
                                            torch.ones((), device="cuda"), torch.ones(1, device="cuda"), stride, pads,
                                            dil, torch.float32).double().sum())
        ops = 2 * C * O * taps
        for what, fns in (("entry", entry), ("wrapper", wrapper)):
            t = [event_ms(torch, fns[lb]) for lb in ("old", "new", "new", "old")]
            print(f"{name} {what}: old {t[0]:.4f} / {t[3]:.4f} ms, new {t[1]:.4f} / {t[2]:.4f} ms (median of 20, L2 "
                  f"flushed); old {ops / (t[0] + t[3]) * 2 / 1e9:.1f} TOP/s, new {ops / (t[1] + t[2]) * 2 / 1e9:.1f} "
                  f"TOP/s; both bit-exact [{tag}]", flush=True)
        torch.cuda.empty_cache()
    for N, C, H, W in QUANTIZE:
        x = (torch.randn(N, C, H, W, generator=g, device="cuda") * 3).to(torch.bfloat16)
        s = torch.tensor(0.0123, device="cuda")
        fns = {"old": lambda: F.pad(tq.quantize_act_with_scale(x, s)[0].permute(0, 2, 3, 1), (0, -C % 16)).contiguous(),
               "new": lambda: tq.quantize_pack(x, s)}
        assert torch.equal(fns["old"](), fns["new"]()), (N, C, H, W)
        t = [event_ms(torch, fns[lb]) for lb in ("old", "new", "new", "old")]
        nbytes = x.numel() * 2 + N * H * W * (C + -C % 16)
        print(f"quantize [{N},{C},{H},{W}] bf16: old (plain quantize + NHWC copy) {t[0]:.4f} / {t[3]:.4f} ms, new "
              f"(quantize_pack) {t[1]:.4f} / {t[2]:.4f} ms; bound {nbytes / 3.35e9:.4f} ms (bytes); equal [{tag}]",
              flush=True)
        torch.cuda.empty_cache()
    runs = {}
    for label in ("old", "new", "new", "old"):
        tree = os.path.abspath(args.old) if label == "old" else ROOT
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--forward", tree], capture_output=True,
                           text=True)
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("FORWARD ")]
        if r.returncode or not line:
            raise SystemExit(f"the {label} forward failed:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        res = json.loads(line[0][8:])
        runs.setdefault(label, []).append(res)
        i8, bf = res["int8_static"], res["bf16"]
        print(f"Full forward, batch 16, bf16 compute ({label} tree): int8_static host {i8['host_ms']:.2f} ms, device "
              f"{i8['device_ms']:.3f} ms; bf16 host {bf['host_ms']:.2f} ms, device {bf['device_ms']:.3f} ms [{tag}]",
              flush=True)
    assert runs["old"][0]["int8_static"]["digest"] == runs["new"][0]["int8_static"]["digest"], \
        "the two trees' int8_static forwards differ"
    return 0


if __name__ == "__main__":
    sys.exit(main())
