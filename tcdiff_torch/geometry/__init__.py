"""Rotation conversions and SMPL forward kinematics, for the train loss and
the dataset."""
