"""Quality metrics of generated motion: the kinetic and geometric feature
maps, FID, diversity, beat alignment, foot skating, collisions and group
motion consistency."""

from tcdiff_torch.eval.metrics import (  # noqa: F401
    beat_alignment_score,
    collision_frequency,
    diversity,
    evaluate,
    extract_features,
    foot_skating_ratio,
    frechet_distance,
    geometric_features,
    group_motion_consistency,
    kinematic_beats,
    kinetic_features,
    music_beats_from_features,
)
