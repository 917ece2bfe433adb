"""allreduce_ms.train: device ms a step in NCCL's all-reduce kernels (the gradient and the loss means), from the profile."""

from benchmark.readers import allreduce_ms as read  # noqa: F401
