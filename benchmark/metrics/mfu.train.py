"""mfu.train: the window's steps' analytic FLOPs a card (benchmark/flops.py) over its wall time and the card's bf16 peak (%)."""

from benchmark.readers import mfu_train as read  # noqa: F401
