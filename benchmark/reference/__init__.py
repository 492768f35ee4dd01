"""The benchmark's plain reference: a frozen plain-PyTorch copy of the port's
routing (`data/warp.py`, `data/geometry.py`, the try-on batches of
`data/dataset.py`) and of its two served generators (`models/generator_full.py`
GeneratorFull, `models/generator_512.py` Generator512, over `nn/` and `ops/`).

It imports nothing of the program.  Departures from the port, each by design:

* every hand-written kernel is its plain version: `norm_warp`, `composite`
  and `denorm_warp` (`ops/warp_kernels.py`), `up2` and `down2`
  (`ops/upfirdn_kernels.py`);
* the int8 serving sites, modes and weight caches are gone (no `quant`
  argument or attribute anywhere); the float path they leave is unchanged;
* `Generator512Plain` and the routes' device and layout checks are left out.

Run it in float32 with TF32 off (`benchmark/harness/precision.py`).
"""
