"""Sample post-processing (FK, long-form stitching, FK pkl export) and the
matplotlib renders (skeletons, DBN trajectories)."""

from tcdiff_torch.viz.postprocess import render_sample, split_sample, stitch_long  # noqa: F401
from tcdiff_torch.viz.render import skeleton_render  # noqa: F401
