"""Typed per-subsystem error hierarchy.

The reference defines one error enum per subsystem and rolls them up
into `AwsmError` (crates/renderer/src/error.rs:26-84 — Core, Camera,
Mesh, Transform, Animation, Skin, Material, Instance, Light, Texture,
...). The Python analog is an exception hierarchy: every renderer
failure raises a subclass of AwsmError carrying the subsystem and a
precise message, so the editor/demo loop can catch at whatever
granularity it wants (`except AwsmError` = the reference's
`Result<T, AwsmError>` boundary) instead of dying on a bare
KeyError/AssertionError deep in numpy."""

from __future__ import annotations


class AwsmError(Exception):
    """Root of all renderer errors (reference error.rs AwsmError)."""


class AllocatorError(AwsmError):
    """Buffer/slot allocation failures (reference: renderer-core
    buffer errors; see utils/allocator.py)."""


class TransformError(AwsmError):
    """Unknown transform key, bad hierarchy (AwsmTransformError)."""


class MeshError(AwsmError):
    """Unknown mesh key, bad geometry, capacity overflow (AwsmMeshError)."""


class MorphError(MeshError):
    """Morph-target limits / malformed morph data (morphs.rs errors)."""


class SkinError(AwsmError):
    """Unknown skin key / joint set limits (AwsmSkinError)."""


class MaterialError(AwsmError):
    """Unknown material key / bad material data (AwsmMaterialError)."""


class TextureError(AwsmError):
    """Unknown texture key / unsupported image (AwsmTextureError)."""


class LightError(AwsmError):
    """Unknown light key (AwsmLightError)."""


class CameraError(AwsmError):
    """Bad camera parameters (AwsmCameraError)."""


class AnimationError(AwsmError):
    """Unknown player/clip, malformed channels (AwsmAnimationError)."""


class InstanceError(AwsmError):
    """Instanced-draw constraint violations (AwsmInstanceError)."""


class ConfigError(AwsmError):
    """Invalid renderer configuration / warmup variant fields."""


class GltfError(AwsmError):
    """Malformed or unsupported glTF/GLB documents (gltf error paths)."""


class EnvironmentError_(AwsmError):
    """Environment / cubemap / IBL load failures (cubemap errors)."""
