"""avatar-room-msaa: twelve skinned, face-animated avatars through the
program's glTF ingest (load_gltf + populate_gltf) and its animation
system (update_all every frame), at 1080p with MSAA-4x.

The asset is generated here as a glTF 2.0 GLB: the Mixamo 65-joint
skeleton (hips, three spine joints, neck, head and head end; per side a
shoulder, arm, forearm, hand and five fingers of four joints, and an
up-leg, leg, foot, toe and toe end), a body of tubes along its bones
skinned with four influences a vertex, a head with ARKit's 52 face
blendshapes as morph targets, and per avatar a looping body clip (every
joint's rotation and the hips' translation) and face clip (the 52
weights). Sizes come from avatar-room-msaa.json; the seed draws the
colours, the clip curves and the target shapes, never a size.

build_scene returns the bind pose, the meshes as the asset holds them;
scene.meta["rig"] carries the skeleton, skins, targets and clips in the
form reference/pose.py reads (it poses a frame's copy of the scene for
the shared reference)."""

from __future__ import annotations

import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _glb  # noqa: E402
import _shapes  # noqa: E402

from port_bench.scene import (  # noqa: E402
    Light, Material, Mesh, Scene, Texture, translation,
)

F = np.float32
FINGERS = ("Thumb", "Index", "Middle", "Ring", "Pinky")


def skeleton():
    """The Mixamo rig in its bind pose (arms lowered 70 degrees from the
    T-pose): (names, parents (-1: the armature node), bind translations
    (J, 3) in the parent's frame, limit class of each joint). Every bind
    rotation is the identity, so the joints' frames are the armature's."""
    names, parents, offs, cls = [], [], [], []

    def add(name, parent, off, kind):
        names.append(name)
        parents.append(-1 if parent is None else names.index(parent))
        offs.append(off)
        cls.append(kind)

    add("Hips", None, (0.0, 0.95, 0.0), "spine")
    add("Spine", "Hips", (0.0, 0.10, 0.0), "spine")
    add("Spine1", "Spine", (0.0, 0.12, 0.0), "spine")
    add("Spine2", "Spine1", (0.0, 0.13, 0.0), "spine")
    add("Neck", "Spine2", (0.0, 0.15, 0.0), "spine")
    add("Head", "Neck", (0.0, 0.09, 0.0), "spine")
    add("HeadTop_End", "Head", (0.0, 0.20, 0.0), "spine")
    down = (math.cos(math.radians(70.0)), -math.sin(math.radians(70.0)))
    for side, sx in (("Left", 1.0), ("Right", -1.0)):
        add(side + "Shoulder", "Spine2", (sx * 0.06, 0.10, 0.0), "arms")
        add(side + "Arm", side + "Shoulder", (sx * 0.12, -0.01, 0.0), "arms")
        add(side + "ForeArm", side + "Arm",
            (sx * 0.28 * down[0], 0.28 * down[1], 0.0), "arms")
        add(side + "Hand", side + "ForeArm",
            (sx * 0.25 * down[0], 0.25 * down[1], 0.0), "arms")
        for f, (dz, reach) in zip(FINGERS, ((0.03, 0.05), (0.025, 0.09),
                                           (0.008, 0.095), (-0.008, 0.09),
                                           (-0.024, 0.08))):
            parent = side + "Hand"
            lengths = (reach, 0.035, 0.025, 0.02)
            for k, ln in enumerate(lengths):
                name = f"{side}Hand{f}{k + 1}"
                if k == 0:
                    off = (sx * (0.02 + ln * down[0]), ln * down[1], dz)
                else:
                    off = (sx * ln * down[0], ln * down[1], 0.0)
                add(name, parent, off, "fingers")
                parent = name
    for side, sx in (("Left", 1.0), ("Right", -1.0)):
        add(side + "UpLeg", "Hips", (sx * 0.09, -0.05, 0.0), "legs")
        add(side + "Leg", side + "UpLeg", (0.0, -0.42, 0.0), "legs")
        add(side + "Foot", side + "Leg", (0.0, -0.42, 0.0), "legs")
        add(side + "ToeBase", side + "Foot", (0.0, -0.04, 0.12), "legs")
        add(side + "Toe_End", side + "ToeBase", (0.0, 0.0, 0.06), "legs")
    return names, np.asarray(parents), np.asarray(offs, np.float64), cls


def _bind_positions(parents, offs):
    pos = np.zeros_like(offs)
    for j, p in enumerate(parents):
        pos[j] = offs[j] + (pos[p] if p >= 0 else 0.0)
    return pos


def _radius(names, c):
    """Tube radius of the bone ending at joint c."""
    n = names[c]
    for key, r in (("Thumb", 0.009), ("Index", 0.008), ("Middle", 0.008),
                   ("Ring", 0.0075), ("Pinky", 0.007), ("Hand", 0.035),
                   ("ForeArm", 0.045), ("Arm", 0.04), ("Shoulder", 0.05),
                   ("UpLeg", 0.08), ("Leg", 0.07), ("Foot", 0.055),
                   ("Toe", 0.035), ("Spine", 0.14), ("Neck", 0.09),
                   ("Head", 0.05)):
        if key in n:
            return r
    return 0.05


def _smooth(e0, e1, x):
    t = np.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _body(cfg, names, parents, bind):
    """Tubes along every bone (parent -> child): `ring` vertices around
    (a seam column repeated), `segments` along, one cap at the child's
    end. Each vertex weighs the bone's joint, its parent near the start
    and the child near the end (at most 4 influences)."""
    a, b = int(cfg["body"]["ring"]), int(cfg["body"]["segments"])
    P, N, UV, Jn, Wt, IDX = [], [], [], [], [], []
    bones = [(parents[c], c) for c in range(len(names)) if parents[c] >= 0]
    nb = len(bones)
    th = np.linspace(0.0, 2.0 * np.pi, a + 1)
    base = 0
    for bi, (p, c) in enumerate(bones):
        p0, p1 = bind[p], bind[c]
        d = p1 - p0
        ln = np.linalg.norm(d)
        d = d / ln
        ref = np.array([0.0, 0.0, 1.0]) if abs(d[2]) < 0.9 else \
            np.array([1.0, 0.0, 0.0])
        e1 = np.cross(d, ref)
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(d, e1)
        r0 = _radius(names, c)
        ext = min(r0 / ln, 0.25)
        s = np.linspace(-ext, 1.0, b + 1)
        radial = np.cos(th)[:, None] * e1 + np.sin(th)[:, None] * e2
        rad = r0 * (1.0 - 0.15 * np.clip(s, 0.0, 1.0))
        pos = p0 + s[:, None, None] * ln * d + rad[:, None, None] * radial
        nrm = np.broadcast_to(radial, pos.shape)
        v0 = 0.5 * bi / nb
        uv = np.stack(np.broadcast_arrays(
            (th / (2 * np.pi))[None, :],
            (v0 + 0.5 / nb * (0.1 + 0.8 * (s - s[0]) / (s[-1] - s[0])))
            [:, None]), -1)
        gp = parents[p]
        w_gp = (0.5 * (1.0 - _smooth(0.0, 0.3, s))) if gp >= 0 else \
            np.zeros_like(s)
        w_c = 0.5 * _smooth(0.7, 1.0, s)
        w = np.stack([1.0 - w_gp - w_c, w_gp, w_c, np.zeros_like(s)], -1)
        jn = np.array([p, max(gp, 0), c, 0])
        P.append(pos.reshape(-1, 3))
        N.append(nrm.reshape(-1, 3))
        UV.append(uv.reshape(-1, 2))
        Wt.append(np.repeat(w, a + 1, axis=0))
        Jn.append(np.tile(jn, ((a + 1) * (b + 1), 1)))
        q = base + (np.arange(b)[:, None] * (a + 1)
                    + np.arange(a)[None, :]).reshape(-1)
        IDX.append(np.stack([q, q + 1, q + a + 1, q + 1, q + a + 2, q + a + 1],
                            1).reshape(-1, 3))
        base += (a + 1) * (b + 1)
        # the cap at the child's end: its own ring (flat normal) and centre
        cap = np.concatenate([pos[-1], p1[None]], 0)
        P.append(cap)
        N.append(np.tile(d, (a + 2, 1)))
        UV.append(np.concatenate([uv[-1], uv[-1][:1]], 0))
        Wt.append(np.tile(w[-1], (a + 2, 1)))
        Jn.append(np.tile(jn, (a + 2, 1)))
        ring = base + np.arange(a)
        IDX.append(np.stack([ring, ring + 1, np.full(a, base + a + 1)], 1))
        base += a + 2
    pos = np.concatenate(P).astype(F)
    nrm = np.concatenate(N).astype(F)
    uv = np.concatenate(UV).astype(F)
    idx = np.concatenate(IDX).astype(np.uint32)
    return dict(positions=pos, normals=nrm, uv0=uv,
                tangents=_glb.tangents(pos, nrm, uv, idx), indices=idx,
                joints=np.concatenate(Jn).astype(np.uint8),
                weights=np.concatenate(Wt).astype(F))


def _vertex_normals(pos, idx):
    n = np.zeros_like(pos)
    p0 = pos[idx[:, 0]]
    fn = np.cross(pos[idx[:, 1]] - p0, pos[idx[:, 2]] - p0)
    for k in range(3):
        np.add.at(n, idx[:, k], fn)
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)


def _head(cfg, names, bind, rng):
    """An ellipsoid about the head joint, its seam at the back, weighted
    to the head and, below the jaw, the neck; 52 targets of smooth bumps
    along the normal on the face side (+z)."""
    hc = cfg["head"]
    nlat, nlon = int(hc["lat"]), int(hc["lon"])
    rx, ry, rz = (float(x) for x in hc["radii"])
    hj, nj = names.index("Head"), names.index("Neck")
    centre = bind[hj] + np.array([0.0, 0.09, 0.01])
    th = np.linspace(0.02 * np.pi, 0.98 * np.pi, nlat + 1)
    ph = np.linspace(0.0, 2.0 * np.pi, nlon + 1)
    T, Pp = np.meshgrid(th, ph, indexing="ij")
    # phi 0 at the back (-z), pi at the face (+z)
    unit = np.stack([-np.sin(T) * np.sin(Pp), np.cos(T),
                     -np.sin(T) * np.cos(Pp)], -1)
    pos = (centre + unit * np.array([rx, ry, rz])).reshape(-1, 3)
    n1 = nlon + 1
    q = (np.arange(nlat)[:, None] * n1 + np.arange(nlon)[None, :]).reshape(-1)
    idx = np.stack([q, q + n1, q + 1, q + 1, q + n1, q + n1 + 1],
                   1).reshape(-1, 3)
    nrm = _vertex_normals(pos, idx)
    uv = np.stack([Pp / (2 * np.pi),
                   0.5 + 0.5 * (T - th[0]) / (th[-1] - th[0])], -1).reshape(-1, 2)
    y = pos[:, 1] - bind[hj, 1]
    w_neck = 0.5 * (1.0 - _smooth(-0.02, 0.04, y))
    weights = np.stack([1.0 - w_neck, w_neck, np.zeros_like(y),
                        np.zeros_like(y)], -1)
    joints = np.tile(np.array([hj, nj, 0, 0]), (pos.shape[0], 1))
    n_t = int(cfg["face_targets"])
    bump = float(hc["bump_m"])
    front = np.nonzero(nrm[:, 2] > 0.45)[0]
    dpos, dnrm = [], []
    for _ in range(n_t):
        c = pos[rng.choice(front)]
        sigma = rng.uniform(0.01, 0.025)
        amp = rng.uniform(0.3, 1.0) * bump * rng.choice((-1.0, 1.0))
        g = np.exp(-np.sum((pos - c) ** 2, -1) / (2.0 * sigma * sigma))
        dp = (amp * g)[:, None] * nrm
        dpos.append(dp)
        dnrm.append(_vertex_normals(pos + dp, idx) - nrm)
    pos, nrm, uv = pos.astype(F), nrm.astype(F), uv.astype(F)
    idx = idx.astype(np.uint32)
    return dict(positions=pos, normals=nrm, uv0=uv,
                tangents=_glb.tangents(pos, nrm, uv, idx), indices=idx,
                joints=joints.astype(np.uint8), weights=weights.astype(F),
                target_positions=np.stack(dpos).astype(F),
                target_normals=np.stack(dnrm).astype(F))


def _maps(cfg, rng, names, parents):
    """The atlas: base colour (sRGB) and normal map. Rows of the upper
    half hold the bones' tube strips (shirt, trousers, skin, shoes by
    bone), the lower half the head's skin with eyes and a mouth."""
    S = int(cfg["map_size"])
    shirt = rng.integers(40, 220, 3)
    trousers = rng.integers(30, 160, 3)
    skin = np.array([[224, 172, 140], [198, 134, 100], [141, 85, 56],
                     [240, 200, 170]])[rng.integers(4)]
    shoes = np.array([40, 36, 34])
    bones = [c for c in range(len(names)) if parents[c] >= 0]
    n_bones = len(bones)
    base = np.empty((S, S, 4), np.uint8)
    base[..., 3] = 255
    half = S // 2
    for bi, c in enumerate(bones):
        n = names[c]
        col = (skin if any(k in n for k in ("Hand", "Neck", "Head"))
               else shoes if ("Foot" in n or "Toe" in n)
               else trousers if ("Leg" in n) else shirt)
        r0, r1 = bi * half // n_bones, (bi + 1) * half // n_bones
        base[r0:r1, :, :3] = col
    base[half:, :, :3] = skin
    yy, xx = np.mgrid[0:S, 0:S].astype(np.float64) / S
    v = (yy - 0.5) * 2.0                       # head latitude, 0 top .. 1
    for ex in (0.455, 0.545):
        eye = ((xx - ex) / 0.018) ** 2 + ((v - 0.42) / 0.02) ** 2 < 1.0
        base[eye & (yy >= 0.5), :3] = (30, 30, 36)
    mouth = ((xx - 0.5) / 0.04) ** 2 + ((v - 0.62) / 0.012) ** 2 < 1.0
    base[mouth & (yy >= 0.5), :3] = (150, 60, 60)
    weave = np.sin(xx * S * np.pi / 8) * np.sin(yy * S * np.pi / 8)
    hx = np.gradient(weave, axis=1) * 2.0
    hy = np.gradient(weave, axis=0) * 2.0
    hx[half:] = 0.0
    hy[half:] = 0.0
    nz = 1.0 / np.sqrt(hx * hx + hy * hy + 1.0)
    nmap = np.empty((S, S, 4), np.uint8)
    nmap[..., 0] = np.clip((-hx * nz * 0.5 + 0.5) * 255, 0, 255)
    nmap[..., 1] = np.clip((-hy * nz * 0.5 + 0.5) * 255, 0, 255)
    nmap[..., 2] = np.clip((nz * 0.5 + 0.5) * 255, 0, 255)
    nmap[..., 3] = 255
    return base, nmap


def _quat_rotvec(r):
    """(..., 3) rotation vectors -> (..., 4) quaternions xyzw."""
    ang = np.linalg.norm(r, axis=-1, keepdims=True)
    half = 0.5 * ang
    k = np.where(ang > 1e-12, np.sin(half) / np.maximum(ang, 1e-12), 0.5)
    return np.concatenate([r * k, np.cos(half)], -1)


def _clips(cfg, cls, rng):
    """One avatar's clips: the body's (joint rotations about the bind
    pose, the hips' offset from it) and the face's (52 weights), as keys
    at times (K,) over one loop; the last key repeats the first."""
    cc = cfg["clip"]
    T = float(cc["seconds"])
    K = int(round(T * cc["keys_per_s"])) + 1
    t = np.linspace(0.0, T, K)
    w = 2.0 * np.pi / T

    def curve(shape):
        ph = rng.uniform(0.0, 2.0 * np.pi, (2,) + shape)
        return (0.6 * np.sin(w * t[(...,) + (None,) * len(shape)] + ph[0])
                + 0.4 * np.sin(2 * w * t[(...,) + (None,) * len(shape)]
                               + ph[1]))

    lim = np.radians([cc["limits_deg"][c] for c in cls])      # (J,)
    rot = _quat_rotvec(curve((len(cls), 3)) / np.sqrt(3.0)
                       * lim[None, :, None])                  # (K, J, 4)
    hips = curve((3,)) * float(cc["hips_m"])                   # (K, 3)
    n_t = int(cfg["face_targets"])
    ph = rng.uniform(0.0, 2.0 * np.pi, (2, n_t))
    m1 = rng.integers(1, 3, n_t)
    m2 = rng.integers(2, 4, n_t)
    face = np.clip(0.5 + 0.5 * (0.7 * np.sin(w * m1 * t[:, None] + ph[0])
                                + 0.3 * np.sin(w * m2 * t[:, None] + ph[1])),
                   0.0, 1.0)                                   # (K, 52)
    for a in (rot, hips, face):
        a[-1] = a[0]
    return dict(times=t.astype(F), rotation=rot.astype(F),
                hips=hips.astype(F), weights=face.astype(F))


def _placements(cfg):
    lay = cfg["layout"]
    out = []
    for row in range(int(lay["rows"])):
        for k in range(int(lay["per_row"])):
            x = (k - (lay["per_row"] - 1) / 2.0) * lay["spacing"] \
                + row * lay["row_offset"]
            out.append(np.array([x, 0.0, -row * lay["row_gap"]]))
    return out


def build_scene(cfg: dict, seed: int) -> Scene:
    rng = np.random.default_rng(seed)
    names, parents, offs, cls = skeleton()
    assert len(names) == int(cfg["joints"])
    bind = _bind_positions(parents, offs)
    body = _body(cfg, names, parents, bind)
    head = _head(cfg, names, bind, rng)
    base, nmap = _maps(cfg, rng, names, parents)
    places = _placements(cfg)
    clips = [_clips(cfg, cls, rng) for _ in places]
    for clip in clips:            # the hips' channel holds the translation
        clip["hips"] = (clip["hips"] + offs[0]).astype(F)
    mat = Material(base_color=np.ones(4, F), metallic=0.0, roughness=0.55,
                   textures={"base": 0, "normal": 1})
    geo = {part: {k: g[k] for k in ("positions", "normals", "uv0",
                                    "tangents", "indices")}
           for part, g in (("body", body), ("head", head))}
    meshes, instances = [], []
    for a, p in enumerate(places):
        for part in ("body", "head"):
            instances.append((len(meshes), a, part))
            meshes.append(Mesh(**geo[part], world=translation(p), material=0))
    sun = cfg["sun"]
    lights = [Light("directional", np.ones(3, F), float(sun["intensity"]),
                    direction=np.asarray(sun["direction"], F))]
    for pl in cfg["point_lights"]:
        lights.append(Light("point", np.ones(3, F), float(pl["intensity"]),
                            position=np.asarray(pl["position"], F),
                            range=float(pl["range"])))
    cam = dict(cfg["camera"])
    lay = cfg["layout"]
    cx = (lay["rows"] - 1) * lay["row_offset"] / 2.0
    cz = -(lay["rows"] - 1) * lay["row_gap"] / 2.0
    cam.update(eye=[cx, cam["eye_height"], cam["distance"]],
               target=[cx, cam["target_height"], cz])
    inv_bind = np.tile(np.eye(4), (len(names), 1, 1))
    inv_bind[:, :3, 3] = -bind
    rig = dict(
        names=names, parents=parents, bind_translation=offs,
        inverse_bind=inv_bind, placements=places, clips=clips,
        parts={"body": dict(joints=body["joints"], weights=body["weights"]),
               "head": dict(joints=head["joints"], weights=head["weights"],
                            target_positions=head["target_positions"],
                            target_normals=head["target_normals"])},
        instances=instances)
    scene = Scene(meshes=meshes, materials=[mat],
                  textures=[Texture(base, srgb=True, kind="color"),
                            Texture(nmap, srgb=False, kind="normal")],
                  lights=lights, env_equirect=_shapes.sky_equirect(),
                  env_size=cfg["env_size"], settings=dict(cfg["render"]),
                  camera=cam, meta={"rig": rig})
    scene.meta["glb"] = lambda: _avatar_glb(body, head, base, nmap, rig)
    return scene


class _Builder(_glb.GlbBuilder):
    """_glb's writer with MAT4 accessors (inverse bind matrices)."""

    def mat4(self, mats) -> int:
        arr = np.ascontiguousarray(
            np.asarray(mats, F).transpose(0, 2, 1).reshape(-1, 16))
        self.accessors.append({"bufferView": self.view(arr.tobytes()),
                               "byteOffset": 0, "componentType": 5126,
                               "count": arr.shape[0], "type": "MAT4"})
        return len(self.accessors) - 1


def _avatar_glb(body, head, base, nmap, rig) -> bytes:
    b = _Builder()
    imgs = [b.image_png(base), b.image_png(nmap)]

    def attrs(g):
        return {"POSITION": b.acc(g["positions"], minmax=True),
                "NORMAL": b.acc(g["normals"]),
                "TANGENT": b.acc(g["tangents"]),
                "TEXCOORD_0": b.acc(g["uv0"]),
                "JOINTS_0": b.acc(g["joints"]),
                "WEIGHTS_0": b.acc(g["weights"])}

    targets = [{"POSITION": b.acc(dp, minmax=True), "NORMAL": b.acc(dn)}
               for dp, dn in zip(head["target_positions"],
                                 head["target_normals"])]
    n_t = len(targets)
    meshes = [
        {"name": "body", "primitives": [{
            "attributes": attrs(body), "material": 0,
            "indices": b.acc(body["indices"].reshape(-1))}]},
        {"name": "head", "weights": [0.0] * n_t, "primitives": [{
            "attributes": attrs(head), "material": 0, "targets": targets,
            "indices": b.acc(head["indices"].reshape(-1))}]}]
    ibm = b.mat4(rig["inverse_bind"])
    names, parents = rig["names"], rig["parents"]
    J = len(names)
    nodes, skins, anims, roots = [], [], [], []
    clip0 = rig["clips"][0]
    times = b.acc(clip0["times"], minmax=True)
    for a, (place, clip) in enumerate(zip(rig["placements"], rig["clips"])):
        arm = len(nodes)
        j0 = arm + 1
        nodes.append({"name": f"Avatar{a}",
                      "translation": [float(x) for x in place],
                      "children": [j0, j0 + J, j0 + J + 1]})
        for j in range(J):
            kids = [j0 + c for c in range(J) if parents[c] == j]
            node = {"name": names[j], "translation":
                    [float(x) for x in rig["bind_translation"][j]]}
            if kids:
                node["children"] = kids
            nodes.append(node)
        nodes.append({"name": f"Avatar{a}Body", "mesh": 0, "skin": a})
        nodes.append({"name": f"Avatar{a}Head", "mesh": 1, "skin": a})
        skins.append({"joints": list(range(j0, j0 + J)),
                      "inverseBindMatrices": ibm, "skeleton": j0})
        roots.append(arm)
        samplers, channels = [], []
        for j in range(J):
            samplers.append({"input": times, "interpolation": "LINEAR",
                             "output": b.acc(clip["rotation"][:, j])})
            channels.append({"sampler": j, "target": {"node": j0 + j,
                                                      "path": "rotation"}})
        samplers.append({"input": times, "interpolation": "LINEAR",
                         "output": b.acc(clip["hips"])})
        channels.append({"sampler": J, "target": {"node": j0,
                                                  "path": "translation"}})
        anims.append({"name": f"Avatar{a}Body", "samplers": samplers,
                      "channels": channels})
        anims.append({"name": f"Avatar{a}Face", "samplers": [{
            "input": times, "interpolation": "LINEAR",
            "output": b.acc(clip["weights"].reshape(-1))}],
            "channels": [{"sampler": 0, "target": {"node": j0 + J + 1,
                                                   "path": "weights"}}]})
    return b.glb({
        "scene": 0, "scenes": [{"nodes": roots}], "nodes": nodes,
        "meshes": meshes, "skins": skins, "animations": anims,
        "materials": [{
            "pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                     "metallicFactor": 0.0,
                                     "roughnessFactor": 0.55},
            "normalTexture": {"index": 1}}],
        "textures": [{"source": i} for i in imgs],
    })


def load_program(scene: Scene, device, workdir: str):
    """The asset as a GLB file through load_gltf + populate_gltf, every
    clip playing from time 0."""
    import awsm_renderer_tpu_torch as P

    from port_bench import program

    path = os.path.join(workdir, "avatar-room-msaa.glb")
    with open(path, "wb") as f:
        f.write(scene.meta["glb"]())
    try:
        r = program.renderer(scene.settings, device)
        P.populate_gltf(r, P.load_gltf(path), autoplay_animations=True)
    finally:
        os.remove(path)
    program.add_lights_and_env(r, scene)
    return r
