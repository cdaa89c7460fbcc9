"""The plain posing reference: a skinned, morphing scene at given clip
times, in plain numpy (float64), for the shared reference renderer.

What it computes, as glTF 2.0 defines it:

1. sampling (3.11): LINEAR keys only; clamped before the first and after
   the last key; translations and weights lerp, rotations slerp along
   the shorter arc. Any other interpolation is refused.
2. the node hierarchy: each joint's local TRS (its bind translation,
   rotation and unit scale, where no channel overrides them) composed
   down the skeleton from the avatar's armature node (its placement).
3. joint matrices (3.7.3): world(joint) @ inverseBindMatrix.
4. morph targets (3.7.2.2): position + sum_k w_k dposition_k, and the
   normal likewise; the tangent has no deltas here and keeps its w.
5. skinning: the vertex's matrix sum_i w_i J_i applied to its morphed
   position; the skinned mesh node's own transform is ignored, as glTF
   says. Normals and tangents go by that matrix's upper-left 3x3 and are
   then normalised: upstream's skin.wgsl rule (not the inverse
   transpose), which the program copies.

Each posed mesh is a copy with world = identity; the scene's materials,
textures, lights and environment are shared with the bind-pose scene.
Nothing here imports the program.

scene.meta["rig"], as configs/avatar-room-msaa.py writes it:
  names, parents (J,) (-1: the armature node), bind_translation (J, 3),
  inverse_bind (J, 4, 4), placements [(3,)] one per avatar,
  clips [dict(times (K,), rotation (K, J, 4) xyzw, hips (K, 3), weights
  (K, T))] one per avatar: the body clip's channels (every joint's
  rotation, joint 0's translation) and the face clip's weights,
  parts {part: dict(joints (V, 4), weights (V, 4)[, target_positions,
  target_normals (T, V, 3)])}, instances [(mesh index, avatar, part)].
"""

from __future__ import annotations

import dataclasses

import numpy as np

F = np.float32


def player_time(updates: int, dt: float, duration: float,
                speed: float = 1.0) -> float:
    """A looping player's time after `updates` steps of dt from 0, by the
    player's own recurrence t <- (t + dt * speed) mod duration, in
    float64."""
    t = 0.0
    for _ in range(updates):
        t += dt * speed
        t %= duration
    return t


def sample(times, values, t: float, interpolation: str = "LINEAR",
           rotation: bool = False) -> np.ndarray:
    """A glTF sampler at time t: values (K, D) at times (K,)."""
    if interpolation != "LINEAR":
        raise ValueError(f"the posing reference takes LINEAR samplers, not "
                         f"{interpolation}")
    times = np.asarray(times, np.float64)
    values = np.asarray(values, np.float64)
    if t <= times[0]:
        return values[0]
    if t >= times[-1]:
        return values[-1]
    i = int(np.searchsorted(times, t, side="right")) - 1
    u = (t - times[i]) / (times[i + 1] - times[i])
    a, b = values[i], values[i + 1]
    if not rotation:
        return a + u * (b - a)
    d = float(a @ b)
    if d < 0.0:
        b, d = -b, -d
    theta = np.arccos(min(d, 1.0))
    if theta < 1e-12:
        return a
    s = np.sin(theta)
    return (np.sin((1.0 - u) * theta) * a + np.sin(u * theta) * b) / s


def trs(t, q, s=(1.0, 1.0, 1.0)) -> np.ndarray:
    """T @ R @ S as a 4x4 (q xyzw, normalised here)."""
    x, y, z, w = np.asarray(q, np.float64) / np.linalg.norm(q)
    m = np.eye(4)
    m[:3, :3] = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]) * np.asarray(s, np.float64)[None, :]
    m[:3, 3] = t
    return m


def joint_matrices(rig: dict, avatar: int, t: float) -> np.ndarray:
    """(J, 4, 4) joint matrices of one avatar with its body clip at t."""
    clip = rig["clips"][avatar]
    parents = rig["parents"]
    J = len(parents)
    root = np.eye(4)
    root[:3, 3] = rig["placements"][avatar]
    worlds = np.zeros((J, 4, 4))
    for j in range(J):
        tr = (sample(clip["times"], clip["hips"], t) if j == 0
              else rig["bind_translation"][j])
        q = sample(clip["times"], clip["rotation"][:, j], t, rotation=True)
        local = trs(tr, q)
        worlds[j] = (worlds[parents[j]] if parents[j] >= 0 else root) @ local
    return worlds @ np.asarray(rig["inverse_bind"], np.float64)


def face_weights(rig: dict, avatar: int, t: float) -> np.ndarray:
    clip = rig["clips"][avatar]
    return sample(clip["times"], clip["weights"], t)


def pose_mesh(mesh, part: dict, jm: np.ndarray, weights=None):
    """(positions, normals, tangents) of a skinned (and morphed) mesh in
    world space, float64."""
    p = np.asarray(mesh.positions, np.float64)
    n = np.asarray(mesh.normals, np.float64)
    tg = np.asarray(mesh.tangents, np.float64)
    if weights is not None and "target_positions" in part:
        w = np.asarray(weights, np.float64)
        p = p + np.einsum("k,kvc->vc", w, part["target_positions"])
        n = n + np.einsum("k,kvc->vc", w, part["target_normals"])
    m = np.einsum("vi,vijk->vjk", np.asarray(part["weights"], np.float64),
                  jm[np.asarray(part["joints"], np.int64)])
    pw = np.einsum("vjk,vk->vj", m[:, :3, :3], p) + m[:, :3, 3]
    m3 = m[:, :3, :3]

    def unit(v):
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True),
                              1e-20)

    nw = unit(np.einsum("vjk,vk->vj", m3, n))
    tw = unit(np.einsum("vjk,vk->vj", m3, tg[:, :3]))
    return pw, nw, np.concatenate([tw, tg[:, 3:]], -1)


def pose_scene(scene, times):
    """A copy of `scene` with every rigged mesh posed: times[a] = (body
    clip time, face clip time) of avatar a."""
    rig = scene.meta["rig"]
    meshes = list(scene.meshes)
    jms = {}
    for mi, a, part in rig["instances"]:
        tb, tf = times[a]
        if a not in jms:
            jms[a] = joint_matrices(rig, a, tb)
        p, n, tg = pose_mesh(scene.meshes[mi], rig["parts"][part], jms[a],
                             face_weights(rig, a, tf))
        meshes[mi] = dataclasses.replace(
            scene.meshes[mi], positions=p.astype(F), normals=n.astype(F),
            tangents=tg.astype(F), world=np.eye(4, dtype=F))
    return dataclasses.replace(scene, meshes=meshes)
