"""Quaternion/pose math (numpy port of the Eigen/tf calls in
`px4_controller.cpp:888-938`). Quaternions are [w, x, y, z]."""

from __future__ import annotations

import numpy as np


def quat_identity() -> np.ndarray:
    return np.array([1.0, 0.0, 0.0, 0.0])


def quat_from_two_vectors(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Shortest-arc rotation taking a to b (Eigen FromTwoVectors)."""
    a = np.asarray(a, float)
    b = np.asarray(b, float)
    na = np.linalg.norm(a)
    nb = np.linalg.norm(b)
    if na == 0 or nb == 0:
        return quat_identity()
    a = a / na
    b = b / nb
    d = float(np.dot(a, b))
    if d >= 1.0 - 1e-12:
        return quat_identity()
    if d <= -1.0 + 1e-12:
        # 180 degrees: pick any orthogonal axis
        axis = np.cross(a, [1.0, 0.0, 0.0])
        if np.linalg.norm(axis) < 1e-9:
            axis = np.cross(a, [0.0, 1.0, 0.0])
        axis = axis / np.linalg.norm(axis)
        return np.array([0.0, *axis])
    axis = np.cross(a, b)
    s = np.sqrt((1.0 + d) * 2.0)
    q = np.array([s / 2.0, *(axis / s)])
    return q / np.linalg.norm(q)


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vector v by quaternion q."""
    w, x, y, z = q
    u = np.array([x, y, z])
    v = np.asarray(v, float)
    return 2.0 * np.dot(u, v) * u + (w * w - np.dot(u, u)) * v \
        + 2.0 * w * np.cross(u, v)


def quat_yaw(q: np.ndarray) -> float:
    """Yaw (Z rotation) of the quaternion."""
    w, x, y, z = q
    return float(np.arctan2(2.0 * (w * z + x * y),
                            1.0 - 2.0 * (y * y + z * z)))


def yaw_quat(yaw: float) -> np.ndarray:
    return np.array([np.cos(yaw / 2.0), 0.0, 0.0, np.sin(yaw / 2.0)])
