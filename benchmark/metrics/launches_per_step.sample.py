"""launches_per_step.sample: the profiled window's device ops over the
sample.step spans of its requests."""

from benchmark.spans import launches_per_step as read  # noqa: F401
