"""One file per hand-written kernel of the program: `cost(args)` gives the
operations and bytes of one launch from the arguments of its C entry point
(as `ops/cuda_kernels.py:CudaKernel.launch` receives them, device last),
`PEAK_OPS` the rate its operations run at, and `DEVICE_NAMES` a pattern of
the device function names it runs under in a trace.  The least time of a
launch is the larger of bytes over `PEAK_BYTES` and operations over
`PEAK_OPS`."""

PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
PEAK_FP32 = 67e12  # float32 outside the tensor cores, FLOP/s
PEAK_INT8 = 1979e12  # int8 tensor-core operations/s, dense
