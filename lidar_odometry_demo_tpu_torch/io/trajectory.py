"""Trajectory output + ATE evaluation.

The reference publishes poses over ROS topics/TF and never evaluates
accuracy offline (SURVEY.md §5 observability). The TPU build needs an
offline parity bar (BASELINE.json: "ATE RMSE vs reference trajectory"), so
this module provides the standard TUM-format trajectory writer and
absolute-trajectory-error metrics.
"""

from __future__ import annotations

import numpy as np


def write_tum(path: str, stamps, translations, quats_wxyz):
    """TUM format: `stamp tx ty tz qx qy qz qw` per line."""
    with open(path, "w") as f:
        for s, t, q in zip(stamps, translations, quats_wxyz):
            f.write(
                f"{s:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n"
            )


def read_tum(path: str):
    data = np.loadtxt(path)
    stamps = data[:, 0]
    t = data[:, 1:4]
    q_xyzw = data[:, 4:8]
    q = np.stack([q_xyzw[:, 3], q_xyzw[:, 0], q_xyzw[:, 1], q_xyzw[:, 2]], -1)
    return stamps, t, q


def ate_rmse(est_t: np.ndarray, gt_t: np.ndarray, align: bool = False) -> float:
    """Absolute trajectory error RMSE over matched poses.

    With align=True applies the closed-form rigid (Umeyama, no scale)
    alignment first — the standard ATE protocol. Both trajectories start at
    the same origin here, so the default compares directly.
    """
    est = np.asarray(est_t, np.float64)
    gt = np.asarray(gt_t, np.float64)
    assert est.shape == gt.shape
    if align:
        mu_e, mu_g = est.mean(0), gt.mean(0)
        E, G = est - mu_e, gt - mu_g
        U, _, Vt = np.linalg.svd(E.T @ G)
        S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
        R = (U @ S @ Vt).T
        est = (R @ E.T).T + mu_g
    err = est - gt
    return float(np.sqrt(np.mean(np.sum(err * err, axis=-1))))


def relative_translation_errors(est_t: np.ndarray, gt_t: np.ndarray, delta: int = 1) -> np.ndarray:
    """Per-step relative translation error magnitudes (drift diagnostics)."""
    de = est_t[delta:] - est_t[:-delta]
    dg = gt_t[delta:] - gt_t[:-delta]
    return np.linalg.norm(de - dg, axis=-1)
