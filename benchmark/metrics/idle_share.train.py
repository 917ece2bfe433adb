"""idle_share.train: the share of the profiled window in which no kernel ran on the card (%), over a few steady steps."""

from benchmark.readers import idle_share as read  # noqa: F401
