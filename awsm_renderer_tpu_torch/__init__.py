"""awsm_renderer_tpu_torch — the PyTorch + CUDA port of awsm_renderer_tpu.

A second package beside the JAX reference: the same key-based scene API
and frame semantics, written in PyTorch, with every TPU kernel on the
ported path rewritten by hand in CUDA C++ for Hopper (csrc/). It imports
no JAX and nothing of the JAX package. See README.md ("PyTorch port").
"""

from .config import AntiAliasing, PostProcessing, RendererConfig, ToneMapping
from .core.animation import (
    AnimationChannel, AnimationClip, AnimationPlayer, AnimationSampler,
    Interpolation, LoopStyle, TargetPath,
)
from .core.lights import Light, LightKind
from .core.materials import (
    AlphaMode, PbrDebug, PbrMaterial, TextureRef, UnlitMaterial,
)
from .core.meshes import MeshGeometry
from .core.textures import MipmapKind, Sampler
from .core.transforms import Transform
from .gltf.loader import load_gltf
from .gltf.populate import populate_gltf
from .interop import device_scene_from_jax
from .renderer import AwsmRendererTorch
from . import errors
from .errors import AwsmError

__all__ = [
    "AwsmRendererTorch", "RendererConfig", "AntiAliasing", "PostProcessing",
    "ToneMapping", "Transform", "MeshGeometry", "PbrMaterial",
    "UnlitMaterial", "AlphaMode", "PbrDebug", "TextureRef", "Light",
    "LightKind", "Sampler", "MipmapKind", "AnimationPlayer",
    "AnimationClip", "AnimationChannel", "AnimationSampler",
    "Interpolation", "LoopStyle", "TargetPath", "device_scene_from_jax",
    "errors", "AwsmError", "load_gltf", "populate_gltf",
]

__version__ = "0.1.0"
