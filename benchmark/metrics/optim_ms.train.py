"""optim_ms.train: device ms a train step of the gradient norm, Adan and
the EMA (train.grad_norm + train.adan + train.ema), from the port's
spans."""

from benchmark.spans import optim_ms as read  # noqa: F401
