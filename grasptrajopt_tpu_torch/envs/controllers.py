"""Mobile-base control math (pure numpy; behavioral parity with
examples/move_to_pose.py and the Fetch differential drive at
examples/pybullet_api.py:471-492)."""

from __future__ import annotations

import numpy as np


def angle_mod(x, zero_2_2pi: bool = False, degree: bool = False):
    """Angle modulo to [-pi, pi) (or [0, 2pi)); floats stay floats."""
    is_float = isinstance(x, float)
    x = np.asarray(x, dtype=np.float64).flatten()
    if degree:
        x = np.deg2rad(x)
    if zero_2_2pi:
        out = x % (2 * np.pi)
    else:
        out = (x + np.pi) % (2 * np.pi) - np.pi
    if degree:
        out = np.rad2deg(out)
    return out.item() if is_float else out


class PathFinderController:
    """P-controller steering a differential-drive base to a 2-D goal
    (Corke's pose controller; parity: move_to_pose.py:77-113)."""

    def __init__(self, Kp_rho: float, Kp_alpha: float, Kp_beta: float):
        self.Kp_rho = Kp_rho
        self.Kp_alpha = Kp_alpha
        self.Kp_beta = Kp_beta

    def calc_control_xy(self, x_diff: float, y_diff: float, theta: float):
        rho = np.hypot(x_diff, y_diff)
        alpha = angle_mod(float(np.arctan2(y_diff, x_diff) - theta))
        v = self.Kp_rho * rho
        w = self.Kp_alpha * alpha
        if alpha > np.pi / 2 or alpha < -np.pi / 2:
            v = -v
        return rho, v, w

    def calc_control_theta(self, theta: float, theta_goal: float):
        beta = angle_mod(float(theta_goal - theta))
        return 0.0, self.Kp_beta * beta


def diff_drive_wheel_velocities(
    lin_vel: float,
    ang_vel: float,
    wheel_radius: float = 0.0613,
    wheel_axle_length: float = 0.372,
) -> np.ndarray:
    """(v, w) -> (right, left) wheel joint velocities for the Fetch base
    (defaults from pybullet_api.py:323-330)."""
    half = wheel_axle_length / 2.0
    left = (lin_vel - ang_vel * half) / wheel_radius
    right = (lin_vel + ang_vel * half) / wheel_radius
    return np.array([right, left])
