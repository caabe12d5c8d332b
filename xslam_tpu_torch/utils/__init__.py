"""Trajectory evaluation and state conversion."""
