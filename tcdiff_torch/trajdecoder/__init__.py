"""The Dance-Beat Navigator (DBN), the trajectory stage: the network
(`model`), its autoregressive rollout, the Kalman filter, the incremental
streamer, the trajectory post-processing, and its training (`dataset`,
`trainer`)."""

from tcdiff_torch.trajdecoder.kalman import kalman_filter_chunk, kalman_smooth_batch  # noqa: F401
from tcdiff_torch.trajdecoder.model import TrajDecoder  # noqa: F401
from tcdiff_torch.trajdecoder.rollout import autoregressive_rollout  # noqa: F401
from tcdiff_torch.trajdecoder.streaming import TrajectoryStreamer  # noqa: F401
