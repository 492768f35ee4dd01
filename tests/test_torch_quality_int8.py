"""`cli.quality_regression --device cpu --quant int8_static` at a thin width,
two steps: the JSON line's keys are the JAX script's with `--quant`
(`scripts/quality_regression.py`, read from its source) and `device`, every
value is finite, and the int8 output moved from the float one.  A file of
its own: the plain int8 convolution is a float64 conv on the CPU."""

from test_torch_quality_cli import QR_THIN, check_line
from test_torch_train_loop import one_torch_thread  # noqa: F401  (autouse fixture)


def test_quality_regression_int8_static_keys(capsys):
    line = check_line(capsys, [*QR_THIN, "--quant", "int8_static"], quant=True)
    assert line["quant_mode"] == "int8_static" and line["quant_pixel_l1"] > 0
