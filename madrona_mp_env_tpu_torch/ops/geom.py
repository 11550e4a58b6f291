"""Rotation/aim math and small vector helpers.

The reference stores an Aim{yaw, pitch, quat} (reference src/types.hpp:455-459,
computeAim in src/utils.cpp:140-167). Every use of the aim quat is a rotate
of a basis vector, so the rotated basis (fwd/right/up) is computed directly
from yaw/pitch trig.

Conventions (madrona): fwd = +y, right = +x, up = +z.
aim rot = Rz(yaw) @ Rx(pitch).

Dot products and norms are written out term by term in a fixed order
(x, then y, then z) so that every device sums them the same way.
"""

from __future__ import annotations

import torch

from .. import consts


def sqrt(x):
    """Correctly rounded float32 square root on every device. ATen's
    vectorized CPU sqrt is not (about 0.6% of float32 inputs come out an
    ulp off, and which elements take the vector path depends on the
    tensor's size), so on the CPU the root is taken in float64 and rounded
    once, which is exact; CUDA's sqrtf already is."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def dot(a, b):
    """Sum over the last (xyz) axis, x + y + z in that order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def norm(v):
    return sqrt(dot(v, v))


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def wrap_pi(angle):
    """One-shot wrap into [-pi, pi] (matches computeAim, utils.cpp:142-146):
    a single conditional add, not a modulo, mirroring the reference."""
    angle = torch.where(angle < -consts.pi, angle + 2.0 * consts.pi, angle)
    angle = torch.where(angle > consts.pi, angle - 2.0 * consts.pi, angle)
    return angle


def compute_aim(yaw, pitch):
    """Wrap yaw, clamp pitch to +-pi/4 (utils.cpp:140-155)."""
    yaw = wrap_pi(yaw)
    pitch = torch.clamp(pitch, -0.25 * consts.pi, 0.25 * consts.pi)
    return yaw, pitch


def aim_vectors(yaw, pitch):
    """(fwd, right, up) unit vectors of the aim frame.

    fwd   = (-sin(yaw)cos(p), cos(yaw)cos(p), sin(p))
    right = (cos(yaw), sin(yaw), 0)
    up    = (sin(yaw)sin(p), -cos(yaw)sin(p), cos(p))
    """
    sy, cy = torch.sin(yaw), torch.cos(yaw)
    sp, cp = torch.sin(pitch), torch.cos(pitch)
    fwd = torch.stack([-sy * cp, cy * cp, sp], dim=-1)
    right = torch.stack([cy, sy, torch.zeros_like(cy)], dim=-1)
    up = torch.stack([sy * sp, -cy * sp, cp], dim=-1)
    return fwd, right, up


def body_fwd_right(yaw):
    """Yaw-only body frame (Quat::angleAxis(yaw, up), sim.cpp:2281)."""
    sy, cy = torch.sin(yaw), torch.cos(yaw)
    fwd = torch.stack([-sy, cy, torch.zeros_like(sy)], dim=-1)
    right = torch.stack([cy, sy, torch.zeros_like(sy)], dim=-1)
    return fwd, right


def rotate_z(v, angle):
    """Rotate vector(s) about +z by angle, keeping z."""
    s, c = torch.sin(angle), torch.cos(angle)
    x = c * v[..., 0] - s * v[..., 1]
    y = s * v[..., 0] + c * v[..., 1]
    z = torch.broadcast_to(v[..., 2], x.shape)
    return torch.stack([x, y, z], dim=-1)


def yaw_pitch_to(vec):
    """Normalized direction -> (yaw, pitch): yaw = -atan2(x, y),
    pitch = asin(clamp(z, -1, 1)) (sim.cpp:2968-2969)."""
    yaw = -torch.atan2(vec[..., 0], vec[..., 1])
    pitch = torch.asin(torch.clamp(vec[..., 2], -1.0, 1.0))
    return yaw, pitch


def normalize(v):
    n = norm(v)[..., None]
    return torch.where(n > 0.0, v / torch.clamp(n, min=1e-30),
                       torch.zeros_like(v))
