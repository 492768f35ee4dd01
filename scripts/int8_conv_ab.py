#!/usr/bin/env python3
"""Old-against-new timing of the port's `int8_conv` CUDA kernel on one NVIDIA GPU.

    python3 scripts/int8_conv_ab.py --old DIR

DIR holds an earlier `int8_conv.cu` and the `ops/quant.py` that wraps it (for
example from `git archive <rev> pasta_gan_tpu_torch`, unpacked under the
gitignored `_archive/`).  Both kernels are built with nvcc and the package's
flags and called through their wrappers (`_int8_conv_kernel`, the operands'
layout included) at the heaviest classes of a full-width Full forward and at
the entry, merge and down-conv classes: each held to `int8_conv_reference`
bit for bit, then timed with CUDA events (L2 flushed by a 256 MB write
before each launch, median of 20) in turns old, new, new, old, with the
int8 operations a second.  Then one batch-16 int8_static forward of a
full-width GeneratorFull (bf16, seed 0, 16 synthetic pairs), host median of
10 ended by a synchronise, in turns old, new, new, old, the two outputs held
equal, beside the bf16 float forward.
"""

import argparse
import os
import statistics
import sys
import time
import types

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pasta_gan_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from pasta_gan_tpu_torch.ops import quant as tq  # noqa: E402

# (N, C, O, k, H, W, stride, ((top, bottom), (left, right)), input dilation)
CASES = {
    "3x3 512->512 32x32 b16": (16, 512, 512, 3, 32, 32, 1, ((1, 1), (1, 1)), 1),
    "3x3 256->256 128x128 b16 (SPADE)": (16, 256, 256, 3, 128, 128, 1, ((1, 1), (1, 1)), 1),
    "3x3 512->256 128x128 b16 (SPADE mlp)": (16, 512, 256, 3, 128, 128, 1, ((1, 1), (1, 1)), 1),
    "6x6 dil2 512->256 32->64 b16 (fold)": (16, 512, 256, 6, 32, 32, 1, ((3, 3), (3, 3)), 2),
    "7x7 3->64 256x256 b32 (entry)": (32, 3, 64, 7, 256, 256, 1, ((3, 3), (3, 3)), 1),
    "1x1 320->256 64x64 b16 (merge)": (16, 320, 256, 1, 64, 64, 1, ((0, 0), (0, 0)), 1),
    "3x3 s2 64->128 257 b32 (down)": (32, 64, 128, 3, 257, 257, 2, ((0, 0), (0, 0)), 1),
}


def load_old(old_dir):
    """The earlier wrapper module, bound to the earlier source's own library."""
    src = open(os.path.join(old_dir, "quant.py")).read().replace(
        "from .cuda_kernels import INT8_CONV, check_tensor, stream_of",
        "from pasta_gan_tpu_torch.ops.cuda_kernels import CudaKernel, check_tensor, stream_of, INT8_CONV as _NEW\n"
        "INT8_CONV = CudaKernel('int8_conv_old', os.path.join(OLD_DIR, 'int8_conv.cu'), 'pasta_int8_conv',"
        " _NEW.argtypes)").replace(
        "stream_of(ops.x.device))", "ops.x.device)")  # `CudaKernel.launch` now takes the device in the stream's place
    old = types.ModuleType("old_quant")
    old.__dict__.update(os=os, OLD_DIR=os.path.abspath(old_dir))
    exec(compile(src, os.path.join(old_dir, "quant.py"), "exec"), old.__dict__)
    return old


def event_ms(fn, iters=20):
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


def host_ms(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def main():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--old", required=True, help="directory with the earlier int8_conv.cu and quant.py")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("int8_conv_ab: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    old = load_old(args.old)
    for k in (ck.INT8_CONV, old.INT8_CONV):
        for line in ck.build_kernels([k]).get(k.source, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {k.name}: {line.strip()}", flush=True)
    tag = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, (N, C, O, k, H, W, stride, pads, dil) in CASES.items():
        xq = torch.randint(-127, 128, (N, C, H, W), generator=g, device="cuda", dtype=torch.int8)
        wq = torch.randint(-127, 128, (O, C, k, k), generator=g, device="cuda", dtype=torch.int8)
        sx, sw = torch.rand(N, 1, 1, 1, generator=g, device="cuda"), torch.rand(O, generator=g, device="cuda")
        a = (xq, wq, sx, sw, stride, pads, dil, torch.bfloat16)
        ref = tq.int8_conv_reference(*a)
        for label, mod in (("old", old), ("new", tq)):
            err = float((mod._int8_conv_kernel(*a).float() - ref.float()).abs().max())
            assert err == 0, f"{name}: the {label} kernel differs from the plain version by {err}"
        t = [event_ms(lambda m=m: m._int8_conv_kernel(*a)) for m in (old, tq, tq, old)]
        ones = torch.ones(N, 1, H, W, dtype=torch.int8, device="cuda")
        taps = float(tq.int8_conv_reference(ones, torch.ones(1, 1, k, k, dtype=torch.int8, device="cuda"),
                                            torch.ones((), device="cuda"), torch.ones(1, device="cuda"), stride, pads,
                                            dil, torch.float32).double().sum())
        ops = 2 * C * O * taps
        print(f"{name}: old {t[0]:.4f} / {t[3]:.4f} ms, new {t[1]:.4f} / {t[2]:.4f} ms (wrapper, median of 20, L2 "
              f"flushed); old {ops / (t[0] + t[3]) * 2 / 1e9:.1f} TOP/s, new {ops / (t[1] + t[2]) * 2 / 1e9:.1f} "
              f"TOP/s; both bit-exact [{tag}]", flush=True)

    from pasta_gan_tpu_torch.cli import test as cli
    from pasta_gan_tpu_torch.data.dataset import SyntheticUvitonDataset, collate, prepare_tryon_batch
    from pasta_gan_tpu_torch.models import GeneratorFull

    gen = GeneratorFull().reset_parameters(torch.Generator().manual_seed(0)).cuda().eval().set_dtype(torch.bfloat16)
    ds = SyntheticUvitonDataset(num_samples=16)
    on_card = lambda d: {k: torch.as_tensor(v, device="cuda") for k, v in d.items()}  # noqa: E731
    person = on_card(collate([ds[i] for i in range(16)]))
    garment = on_card(collate([ds[(i + 1) % 16] for i in range(16)]))
    b = {k: v.to(torch.bfloat16) for k, v in prepare_tryon_batch(person, garment, device="cuda").items()}
    w_avg = torch.zeros(512, device="cuda")
    print(f"Full bf16 float forward, batch 16: {host_ms(lambda: cli.tryon_forward(gen, w_avg, b)):.2f} ms [{tag}]")
    cli.calibrate_int8_static(gen, w_avg, [b])
    new_kernel, outs = tq._int8_conv_kernel, {}
    try:
        for label in ("old", "new", "new", "old"):
            tq._int8_conv_kernel = old._int8_conv_kernel if label == "old" else new_kernel
            outs[label] = cli.tryon_forward(gen, w_avg, b)
            ms = host_ms(lambda: cli.tryon_forward(gen, w_avg, b))
            print(f"Full int8_static forward, batch 16, bf16 ({label} kernel): {ms:.2f} ms host median of 10 [{tag}]",
                  flush=True)
    finally:
        tq._int8_conv_kernel = new_kernel
    assert torch.equal(outs["old"], outs["new"]), "the two kernels' forwards differ"


if __name__ == "__main__":
    main()
