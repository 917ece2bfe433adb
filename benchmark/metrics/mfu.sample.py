"""mfu.sample: the window's requests' analytic FLOPs (benchmark/flops.py) over its wall time and the card's bf16 peak (%)."""

from benchmark.readers import mfu_sample as read  # noqa: F401
