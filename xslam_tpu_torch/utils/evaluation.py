"""Trajectory evaluation: ATE and RPE RMSE.

The reference dumps per-frame estimated and ground-truth poses (both
normalized to frame 0, ``Experiments/test_xkinect_fusion/main.cpp:63-75``)
and leaves ATE to offline tooling. Here the evaluator is in-repo.

Own copy of ``xslam_tpu/utils/evaluation.py``: the port imports nothing of
``xslam_tpu``, whose package imports load JAX.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def normalize_to_first(poses: Sequence[np.ndarray]) -> List[np.ndarray]:
    """gt normalization of main.cpp:72: ``pose0^-1 @ pose_i``."""
    inv0 = np.linalg.inv(poses[0])
    return [inv0 @ p for p in poses]


def ate_rmse(est: Sequence[np.ndarray], gt: Sequence[np.ndarray], align=False) -> float:
    """Absolute trajectory error (RMSE over translations), both trajectories
    already expressed relative to their first frame. ``align=True`` applies a
    closed-form SE(3) (Umeyama, no scale) alignment first."""
    est_t = np.stack([p[:3, 3] for p in est])
    gt_t = np.stack([p[:3, 3] for p in gt])
    assert est_t.shape == gt_t.shape
    if align:
        mu_e, mu_g = est_t.mean(0), gt_t.mean(0)
        H = (est_t - mu_e).T @ (gt_t - mu_g)
        U, _, Vt = np.linalg.svd(H)
        S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
        R = Vt.T @ S @ U.T
        est_t = (R @ (est_t - mu_e).T).T + mu_g
    err = est_t - gt_t
    return float(np.sqrt(np.mean(np.sum(err * err, axis=1))))



def rpe_rmse(est: Sequence[np.ndarray], gt: Sequence[np.ndarray], delta: int = 1) -> float:
    """Relative pose error (translational RMSE over ``delta``-frame steps)."""
    errs = []
    for i in range(len(est) - delta):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        rel = np.linalg.inv(dg) @ de
        errs.append(np.sum(rel[:3, 3] ** 2))
    return float(np.sqrt(np.mean(errs)))
