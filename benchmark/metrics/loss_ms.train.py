"""loss_ms.train: device ms a train step of its loss forward (train.loss),
from the port's spans."""

from benchmark.spans import loss_ms as read  # noqa: F401
