#!/usr/bin/env python3
"""Time variants of the port's `csrc/int8_conv.cu` on one NVIDIA GPU, to find
what bounds it:

    python3 scripts/int8_conv_variants.py [--source NAME=FILE ...]

Each variant is the checkout's source with one part switched off by text
substitution (`no_store`: the epilogue's global stores; `no_epilogue`: the
whole epilogue), or another whole source given with `--source` (an earlier
design, e.g. from `git show <rev>:pasta_gan_tpu_torch/csrc/int8_conv.cu`).
Each is built by nvcc with the package's flags into a library of its own and
called through its C entry point at the classes below: the median ms of 20
launches (CUDA events) after a 256 MB write that flushes the L2, the same
without the flush, and 10 launches back to back.  A variant with a part
switched off writes wrong outputs; only its time is read.
"""

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# variant -> (text, replacement) pairs applied to the checkout's source
SUBS = {
    "full": [],
    "no_store": [("for (int col = warp; col < EPI_COLS; col += 4) {",
                  "for (int col = warp; col < EPI_COLS && O < 0; col += 4) {")],
    "no_epilogue": [("      store_tile<BN, MI>(acc,", "      if (O < 0) store_tile<BN, MI>(acc,")],
}
# (N, C, O, k, H, W, stride, ((top, bottom), (left, right)), input dilation)
CASES = [(16, 128, 128, 3, 128, 128, 1, ((1, 1), (1, 1)), 1), (16, 128, 128, 1, 128, 128, 1, ((0, 0), (0, 0)), 1),
         (32, 64, 64, 3, 256, 256, 1, ((1, 1), (1, 1)), 1), (16, 512, 512, 3, 32, 32, 1, ((1, 1), (1, 1)), 1),
         (16, 256, 128, 3, 128, 128, 1, ((1, 1), (1, 1)), 1), (16, 128, 64, 6, 128, 128, 1, ((3, 3), (3, 3)), 2),
         (16, 128, 64, 1, 256, 256, 1, ((0, 0), (0, 0)), 1), (32, 64, 64, 1, 256, 256, 1, ((0, 0), (0, 0)), 1)]


def event_ms(torch, fn, iters=20, flush=True):
    scratch = torch.empty(64 * 1024 * 1024, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        if flush:
            scratch.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def main():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--source", action="append", default=[], metavar="NAME=FILE",
                   help="another whole int8_conv.cu to time beside the checkout's")
    args = p.parse_args()
    import torch

    from pasta_gan_tpu_torch.ops import cuda_kernels as ck
    from pasta_gan_tpu_torch.ops import quant as tq

    if not torch.cuda.is_available():
        raise SystemExit("int8_conv_variants: needs an NVIDIA GPU")
    src = open(ck.INT8_CONV.source_path).read()
    sources = {}
    for name, subs in SUBS.items():
        s = src
        for a, b in subs:
            if a not in s:
                raise SystemExit(f"variant {name}: the source no longer holds {a!r}")
            s = s.replace(a, b)
        sources[name] = s
    for spec in args.source:
        name, path = spec.split("=", 1)
        sources[name] = open(path).read()
    tmp = tempfile.mkdtemp()
    procs = {}
    for name, s in sources.items():
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as f:
            f.write(s)
        procs[name] = subprocess.Popen([ck._nvcc(), *ck.NVCC_FLAGS, "-I", ck.CSRC_DIR, "-o",
                                        os.path.join(tmp, f"{name}.so"), path],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        fn = getattr(ctypes.CDLL(os.path.join(tmp, f"{name}.so")), "pasta_int8_conv")
        fn.argtypes, fn.restype = ck.INT8_CONV.argtypes, ctypes.c_int
        fns[name] = fn
    tag = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(0)
    for N, C, O, k, H, W, stride, pads, dil in CASES:
        xq = torch.randint(-127, 128, (N, C, H, W), generator=g, device="cuda", dtype=torch.int8)
        wq = torch.randint(-127, 128, (O, C, k, k), generator=g, device="cuda", dtype=torch.int8)
        sx, sw = torch.rand(N, generator=g, device="cuda"), torch.rand(O, generator=g, device="cuda")
        ops = tq.kernel_operands(xq, wq, stride, pads, dil)
        y = torch.empty(N, O, *ops.out_hw, dtype=torch.bfloat16, device="cuda")
        _, Hh, Ww, cp = ops.x.shape
        stream = torch.cuda.current_stream().cuda_stream

        def call(fn):
            rc = fn(ops.x.data_ptr(), ops.w.data_ptr(), ops.taps.data_ptr(), ops.ntaps.data_ptr(), sx.data_ptr(), 1,
                    sw.data_ptr(), y.data_ptr(), 1, N, cp, Hh, Ww, O, *ops.out_hw, stride, dil, ops.w.shape[2],
                    ops.taps.shape[1], stream)
            if rc:
                raise SystemExit(f"launch failed with CUDA error {rc}")

        times = [f"{name} {event_ms(torch, lambda f=f: call(f)):.4f}" for name, f in fns.items()]
        full = fns["full"]
        times.append(f"full without the flush {event_ms(torch, lambda: call(full), flush=False):.4f}")
        ten = event_ms(torch, lambda: [call(full) for _ in range(10)], 5, False) / 10
        times.append(f"full 10 back to back {ten:.4f}")
        print(f"{k}x{k} s{stride} d{dil} {C}->{O} [{N},{C},{H},{W}]: " + ", ".join(times) + f" ms [{tag}]", flush=True)


if __name__ == "__main__":
    main()
