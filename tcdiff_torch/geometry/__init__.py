"""Rotation conversions and SMPL forward kinematics for the train loss."""
