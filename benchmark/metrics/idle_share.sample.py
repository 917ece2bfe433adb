"""idle_share.sample: the share of the profiled window in which no kernel ran on the card (%), over one steady request."""

from benchmark.readers import idle_share as read  # noqa: F401
