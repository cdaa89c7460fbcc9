"""Host-side 3D math (numpy): mat4/quat/TRS, projections.

Equivalent role to the reference's use of `glam` on the Rust side
(crates/renderer/src/transforms.rs:458, camera math in frontend).
All matrices are row-major numpy (4,4) float32; vectors are row vectors
multiplied as ``M @ v`` with column-vector convention (same as glam's
``Mat4 * Vec4``).
"""

from __future__ import annotations

import numpy as np

F = np.float32


def mat4_identity() -> np.ndarray:
    return np.eye(4, dtype=F)


def quat_identity() -> np.ndarray:
    return np.array([0.0, 0.0, 0.0, 1.0], dtype=F)  # x, y, z, w


def quat_normalize(q: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(q)
    if n == 0:
        return quat_identity()
    return (q / n).astype(F)


def quat_normalize_rows(q: np.ndarray) -> np.ndarray:
    """quat_normalize on each row of a float32 (N, 4) array, to the bit:
    the squared norm through the same float32 dot (a row times itself,
    which matmul takes to the dot that linalg.norm uses), then the same
    division; the identity where the norm is 0."""
    n = np.sqrt(np.matmul(q[:, None, :], q[:, :, None])[:, 0, 0])
    zero = n == 0
    out = (q / np.where(zero, F(1), n)[:, None]).astype(F)
    out[zero] = quat_identity()
    return out


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dtype=F,
    )


def quat_from_axis_angle(axis, angle: float) -> np.ndarray:
    axis = np.asarray(axis, dtype=F)
    axis = axis / np.linalg.norm(axis)
    s = np.sin(angle / 2.0)
    return np.array([axis[0] * s, axis[1] * s, axis[2] * s, np.cos(angle / 2.0)], dtype=F)


def quat_to_mat3(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    x2, y2, z2 = x + x, y + y, z + z
    xx, yy, zz = x * x2, y * y2, z * z2
    xy, xz, yz = x * y2, x * z2, y * z2
    wx, wy, wz = w * x2, w * y2, w * z2
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ],
        dtype=F,
    )


def quat_slerp(a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    d = float(np.dot(a, b))
    if d < 0.0:
        b = -b
        d = -d
    if d > 0.9995:
        out = a + t * (b - a)
        return quat_normalize(out.astype(F))
    theta = np.arccos(np.clip(d, -1.0, 1.0))
    s = np.sin(theta)
    w0 = np.sin((1.0 - t) * theta) / s
    w1 = np.sin(t * theta) / s
    return (w0 * a + w1 * b).astype(F)


def trs_to_mat4(t, r, s) -> np.ndarray:
    """Compose translation (3,), rotation quat (4,), scale (3,) into mat4."""
    m = np.eye(4, dtype=F)
    rot = quat_to_mat3(np.asarray(r, dtype=F))
    m[:3, :3] = rot * np.asarray(s, dtype=F)[None, :]
    m[:3, 3] = np.asarray(t, dtype=F)
    return m


def mat4_decompose(m: np.ndarray):
    """Decompose mat4 -> (translation, rotation quat, scale). Assumes TRS."""
    t = m[:3, 3].copy()
    rot = m[:3, :3].astype(np.float64)
    sx = np.linalg.norm(rot[:, 0])
    sy = np.linalg.norm(rot[:, 1])
    sz = np.linalg.norm(rot[:, 2])
    if np.linalg.det(rot) < 0:
        sx = -sx
    r3 = rot / np.array([sx, sy, sz])[None, :]
    # matrix -> quat (Shepperd's method)
    tr = r3[0, 0] + r3[1, 1] + r3[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array(
            [(r3[2, 1] - r3[1, 2]) / s, (r3[0, 2] - r3[2, 0]) / s, (r3[1, 0] - r3[0, 1]) / s, 0.25 * s]
        )
    elif r3[0, 0] > r3[1, 1] and r3[0, 0] > r3[2, 2]:
        s = np.sqrt(1.0 + r3[0, 0] - r3[1, 1] - r3[2, 2]) * 2
        q = np.array(
            [0.25 * s, (r3[0, 1] + r3[1, 0]) / s, (r3[0, 2] + r3[2, 0]) / s, (r3[2, 1] - r3[1, 2]) / s]
        )
    elif r3[1, 1] > r3[2, 2]:
        s = np.sqrt(1.0 + r3[1, 1] - r3[0, 0] - r3[2, 2]) * 2
        q = np.array(
            [(r3[0, 1] + r3[1, 0]) / s, 0.25 * s, (r3[1, 2] + r3[2, 1]) / s, (r3[0, 2] - r3[2, 0]) / s]
        )
    else:
        s = np.sqrt(1.0 + r3[2, 2] - r3[0, 0] - r3[1, 1]) * 2
        q = np.array(
            [(r3[0, 2] + r3[2, 0]) / s, (r3[1, 2] + r3[2, 1]) / s, 0.25 * s, (r3[1, 0] - r3[0, 1]) / s]
        )
    return t.astype(F), quat_normalize(q.astype(F)), np.array([sx, sy, sz], dtype=F)


def normal_matrix(world: np.ndarray) -> np.ndarray:
    """Inverse-transpose of the upper-left 3x3 (for normals)."""
    m3 = world[:3, :3].astype(np.float64)
    try:
        inv = np.linalg.inv(m3)
    except np.linalg.LinAlgError:
        inv = np.eye(3)
    return inv.T.astype(F)


def perspective(fovy: float, aspect: float, near: float, far: float) -> np.ndarray:
    """Right-handed perspective, depth range [0, 1] (WebGPU convention)."""
    f = 1.0 / np.tan(fovy / 2.0)
    m = np.zeros((4, 4), dtype=F)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = far / (near - far)
    m[2, 3] = near * far / (near - far)
    m[3, 2] = -1.0
    return m


def orthographic(left, right, bottom, top, near, far) -> np.ndarray:
    """Right-handed orthographic, depth range [0, 1]."""
    m = np.eye(4, dtype=F)
    m[0, 0] = 2.0 / (right - left)
    m[1, 1] = 2.0 / (top - bottom)
    m[2, 2] = 1.0 / (near - far)
    m[0, 3] = (right + left) / (left - right)
    m[1, 3] = (top + bottom) / (bottom - top)
    m[2, 3] = near / (near - far)
    return m


def look_at(eye, center, up) -> np.ndarray:
    """Right-handed view matrix."""
    eye = np.asarray(eye, dtype=np.float64)
    center = np.asarray(center, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=F)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m
