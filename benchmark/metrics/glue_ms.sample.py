"""glue_ms.sample: device ms a DDIM step of the guided call outside the
port's kernels (PyTorch's own kernels and idle around them: the plain
cross-attention, FiLM, the time tokens, the CFG combine): sample.guided
less its outermost k* spans, from the port's spans."""

from benchmark.spans import glue_ms as read  # noqa: F401
