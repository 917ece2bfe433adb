"""Adan and the EMA of the parameters."""
