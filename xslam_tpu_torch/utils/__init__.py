"""Trajectory evaluation, state conversion and checkpoints."""
