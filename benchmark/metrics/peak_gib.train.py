"""peak_gib.train: torch.cuda.max_memory_allocated over the run (GiB), the fullest card's."""

from benchmark.readers import peak_gib as read  # noqa: F401
