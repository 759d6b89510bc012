"""Host matrix math (numpy float32).

Same conventions as the JAX package's ``utils/mathutil.py``: row-major
(4, 4) matrices applied to column vectors (``clip = P @ V @ M @ p``),
Vulkan zero-to-one clip depth with the reference's Y flip, depth cleared
to 1.0.
"""
from __future__ import annotations

import numpy as np


def perspective(fov_y_deg: float, aspect: float, near: float, far: float) -> np.ndarray:
    """Vulkan-style perspective: RH, zero-to-one depth, Y flipped
    (``glm::perspective`` RH_ZO then the reference's ``[1][1] *= -1``)."""
    f = 1.0 / np.tan(np.radians(fov_y_deg) * 0.5)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = -f
    m[2, 2] = far / (near - far)
    m[2, 3] = -(far * near) / (far - near)
    m[3, 2] = -1.0
    return m


def orthographic(left: float, right: float, bottom: float, top: float,
                 near: float, far: float) -> np.ndarray:
    """``glm::ortho`` RH_ZO equivalent (the sun's shadow matrix)."""
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = 2.0 / (right - left)
    m[1, 1] = 2.0 / (top - bottom)
    m[2, 2] = -1.0 / (far - near)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 3] = -near / (far - near)
    return m


def look_at(eye, center, up) -> np.ndarray:
    """``glm::lookAt`` (RH) equivalent."""
    eye = np.asarray(eye, dtype=np.float32)
    center = np.asarray(center, dtype=np.float32)
    up = np.asarray(up, dtype=np.float32)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def rotate_x(v: np.ndarray, angle_rad: float) -> np.ndarray:
    """``glm::rotateX`` equivalent (rotate vector about +X)."""
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    x, y, z = v
    return np.array([x, c * y - s * z, s * y + c * z], dtype=np.float32)


def rotate_y(v: np.ndarray, angle_rad: float) -> np.ndarray:
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    x, y, z = v
    return np.array([c * x + s * z, y, -s * x + c * z], dtype=np.float32)


def rotate_z(v: np.ndarray, angle_rad: float) -> np.ndarray:
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    x, y, z = v
    return np.array([c * x - s * y, s * x + c * y, z], dtype=np.float32)

