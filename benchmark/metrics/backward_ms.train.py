"""backward_ms.train: device ms a train step of its backward
(train.backward), from the port's spans."""

from benchmark.spans import backward_ms as read  # noqa: F401
