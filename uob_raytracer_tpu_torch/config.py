"""Render configuration — a copy of ``uob_raytracer_tpu/config.py``, so that
the port reads it without importing the JAX package.

The reference spreads its configuration over compile-time ``#define``s in two
files that must be edited in sync (``Source/skeleton.cpp:27-34`` and
``Source/kernels.cl:7-19``) plus hard-coded globals (``Source/skeleton.cpp:61-74``).
Here there is a single frozen dataclass: it is hashable, and one instance
fully determines the frame (image size, AA grid, shadow sampling, bounce
budget, quirk flags).
"""
from __future__ import annotations

import dataclasses
import enum


class ShadingModel(enum.Enum):
    """Which of the reference's two (inconsistent) constant sets to use.

    DEVICE: the live GPU-kernel constants — light_color=(16,16,16),
      indirect=(0.5,0.5,0.5) (``Source/kernels.cl:3-4``).
    HOST: the vestigial CPU path's constants — light_color=14*(1,1,1),
      indirect=0.25*(1,1,1) (``Source/skeleton.cpp:69-70``), used by the
      "CPU ref" baseline config.
    """

    DEVICE = "device"
    HOST = "host"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters (hashable).

    Defaults reproduce the reference's full GPU pipeline at 1024x1024
    (``Source/kernels.cl:7-19,316-317,343``).
    """

    width: int = 1024
    height: int = 1024
    # 2x2 supersampled anti-aliasing grid (kernels.cl:12-14).
    aa_x: int = 2
    aa_y: int = 2
    # Soft shadows: jittered occlusion samples toward the light
    # (kernels.cl:316-317: light_sources=10, light_spread=0.05).
    shadow_samples: int = 10
    light_spread: float = 0.05
    # Specular bounce budget (kernels.cl:343).
    bounces: int = 10
    # Refractive indices (kernels.cl:18-19).
    ior_glass: float = 1.52
    ior_air: float = 1.0
    # Ray-offset bias used when spawning secondary/shadow rays (kernels.cl:5).
    bias: float = 1e-4
    # Focal length in *virtual sample grid* pixels. The reference hardcodes
    # 2200.0 against a 1024*2 = 2048-wide virtual grid (skeleton.cpp:61,
    # kernels.cl:384). We keep that FOV for any resolution by scaling:
    # effective_focal = focal_length * (width * aa_x) / 2048.
    focal_length: float = 2200.0
    # --- feature flags -----------------------------------------------------
    # Reproduce the reference's total-internal-reflection bug: the TIR check
    # `c2 < 0` at kernels.cl:78 can never fire because c2 is the result of a
    # sqrt (negative argument -> NaN, and NaN < 0 is false), so TIR rays get
    # NaN directions and render black. Default False = physically correct TIR
    # (reflect when the discriminant is negative).
    quirk_nan_tir: bool = False
    # Fresnel-weighted glass (Schlick) — an extension beyond the reference
    # (which refracts with unit weight). Required by BASELINE config 4.
    fresnel: bool = False
    # CPU-reference mode: reproduce the vestigial scalar CPU renderer
    # (skeleton.cpp:184-279): single unnormalized primary ray per pixel,
    # one hard shadow ray with relative bias 1e-3, HOST shading constants,
    # no AA / spheres / bounces.
    cpu_ref: bool = False
    shading: ShadingModel = ShadingModel.DEVICE
    # CPU-ref hard-shadow bias (skeleton.cpp:229: start += r * 0.001).
    cpu_ref_bias: float = 1e-3

    def __post_init__(self):
        if self.cpu_ref:
            object.__setattr__(self, "aa_x", 1)
            object.__setattr__(self, "aa_y", 1)
            object.__setattr__(self, "shadow_samples", 1)
            object.__setattr__(self, "bounces", 0)
            object.__setattr__(self, "shading", ShadingModel.HOST)

    @property
    def aa_rays(self) -> int:
        return self.aa_x * self.aa_y

    @property
    def effective_focal(self) -> float:
        """Focal length scaled so the FOV matches the reference at any size."""
        if self.cpu_ref:
            # CPU path: focal used directly against a width-wide pixel grid
            # (skeleton.cpp:259) — the reference's 2200 at 1024 wide.
            return self.focal_length * self.width / 1024.0
        return self.focal_length * (self.width * self.aa_x) / 2048.0


def baseline_configs() -> dict[str, RenderConfig]:
    """The five BASELINE.json benchmark configs (see BASELINE.md)."""
    return {
        # 1. Cornell Box 256x256, primary rays + hard shadows, 0 bounces.
        "cpu_ref_256": RenderConfig(width=256, height=256, cpu_ref=True),
        # 2. Cornell Box 512x512 with soft shadows (16 area-light samples).
        "soft_shadows_512": RenderConfig(
            width=512, height=512, aa_x=1, aa_y=1, shadow_samples=16, bounces=0
        ),
        # 3. Cornell Box + mirror sphere, 2 reflection bounces.
        "mirror_512": RenderConfig(
            width=512, height=512, aa_x=1, aa_y=1, shadow_samples=10, bounces=2
        ),
        # 4. Cornell Box + glass sphere, reflection+refraction (Fresnel), 4 bounces.
        "glass_fresnel_512": RenderConfig(
            width=512, height=512, aa_x=1, aa_y=1, shadow_samples=10, bounces=4,
            fresnel=True,
        ),
        # 5. 1024x1024 4x supersampled full scene (fwd+bwd benchmark config).
        "full_1024": RenderConfig(),
    }
