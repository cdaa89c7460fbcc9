"""Renderer configuration.

TPU-native analog of the reference's builder options + runtime setters
(crates/renderer/src/lib.rs:132-260, anti_alias.rs:9-99, post_process.rs:7-64).
Frozen dataclasses act as static args of jitted pipeline stages, so changing
one is a recompile trigger — exactly the reference's "rebuild pipelines"
events (SURVEY §3.5).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional, Tuple


class ToneMapping(enum.Enum):
    """Reference: post_process.rs ToneMapping { None, KhronosPbrNeutral, Aces }."""

    NONE = "none"
    KHRONOS_PBR_NEUTRAL = "khronos_pbr_neutral"
    ACES = "aces"


@dataclass(frozen=True)
class PostProcessing:
    """Reference: post_process.rs:7-64."""

    tonemapping: ToneMapping = ToneMapping.KHRONOS_PBR_NEUTRAL
    bloom: bool = False
    dof: bool = False


@dataclass(frozen=True)
class AntiAliasing:
    """Reference: anti_alias.rs:9-99 (msaa None|4, smaa, mipmaps).

    On TPU there is no hardware MSAA; two software equivalents:
    - `msaa`: MSAA-4x semantics — coverage + depth rasterized at 2x2
      samples per pixel (slim raster), shading ONCE per display pixel,
      per-sample edge-aware resolve. The reference's
      msaa_sample_count=4 cost model.
    - `supersample`: brute-force SSAA — the full pipeline at 2x with a
      box resolve (higher quality than MSAA 4x, ~4x the shading cost).
    """

    supersample: bool = False
    msaa: bool = False
    smaa: bool = False
    mipmap: bool = True
    # Temporal AA + reuse (TAA): Halton-jittered camera, history
    # reprojection, invalid-unit-only shading (passes/frame.py
    # render_frame_temporal). The reference ships this path disabled
    # (camera.rs:13 APPLY_JITTER=false, get_halton_jitter:257); here it
    # is the production route past the measured non-temporal shading
    # floor (BASELINE.md). Mutually exclusive with msaa/supersample —
    # jitter accumulation IS the anti-aliasing. Best for content-static
    # scenes under camera motion: any CONTENT flush (animation,
    # material edits) resets the history, so per-frame-animated scenes
    # pay a full-budget reshade every frame — prefer msaa there.
    temporal: bool = False


@dataclass(frozen=True)
class Temporal:
    """Tuning for the temporal-reuse path (AntiAliasing.temporal)."""

    # shade budget per frame as a fraction of the frame's (8, 128) units;
    # a STATIC cost — invalid (disoccluded) units take it first, refresh
    # units the remainder. 0.12 measured 18.96 ms vs 0.20's 20.51 on the
    # 1080p orbit bench with indistinguishable output (diff-vs-msaa mean
    # 0.048 vs 0.041, both AA-method noise); full refresh rotates every
    # ~1/cap_frac ≈ 8 frames, ample for view-dependent shading
    cap_frac: float = 0.12
    # (no refresh-period knob: the budget is a STATIC cost, so spare
    # budget always reshades the oldest units — every unit refreshes at
    # least once per ~n_units/cap frames with no tuning)
    # exponential-accumulation weight of the new sample at refresh
    alpha: float = 0.12


@dataclass(frozen=True)
class RendererConfig:
    width: int = 1920
    height: int = 1080
    clear_color: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    anti_aliasing: AntiAliasing = field(default_factory=AntiAliasing)
    post_processing: PostProcessing = field(default_factory=PostProcessing)
    # capacity knobs (recompile triggers when stores outgrow them; the
    # scene rounds these up in powers of two, mirroring buffer doubling)
    max_transparent_layers: int = 4  # K-buffer depth for the forward pass
    # tiled light lists (passes/light_culling.py): None = auto-engage
    # when lights.count > 8; True/False force the tiled/dense loop
    light_tiles: Optional[bool] = None
    temporal: Temporal = field(default_factory=Temporal)
    # internal compute dtype for shading; textures/geometry stay f32
    dtype: str = "float32"

    @property
    def render_width(self) -> int:
        return self.width * 2 if self.anti_aliasing.supersample else self.width

    @property
    def render_height(self) -> int:
        return self.height * 2 if self.anti_aliasing.supersample else self.height
