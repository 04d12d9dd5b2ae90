"""Engine configuration (port of raytracing_cuda_tpu/utils/config.py).

The reference hard-codes every knob as a file-static global (resolution
main.cpp:40-47). Here the render path's knobs live in one frozen dataclass,
validated at construction.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 1280            # default framebuffer (main.cpp:42-43)
    height: int = 720
    scene: str = "island"        # 'island' | 'classic'
    antialiasing: bool = True    # FXAA default on (scene.cpp:24)
    sky_source: str = "procedural"  # or 'auto' (→ procedural)
    procedural_sky_shape: tuple = (2048, 4096)
    aspect: float | None = None  # None → width/height
    shard_interleave: int = 1    # sharded engines: strided sub-bands per
    # device (device d renders row chunks d, d+n, …); 1 = contiguous bands.
    # The frame is bit-identical either way.
    # NOTE: the reference initializes camera corners with aspect = 1.7777
    # (scene.cpp:20) and refreshes them only on mouse motion; set
    # aspect=1.7777 to reproduce that quirk.

    _SCENES = ("island", "classic")
    _SKY_SOURCES = ("auto", "procedural")

    def __post_init__(self):
        if self.width < 2 or self.height < 2:
            raise ValueError(f"framebuffer must be at least 2x2, got "
                             f"{self.width}x{self.height}")
        if self.scene not in self._SCENES:
            raise ValueError(f"scene must be one of {self._SCENES}, got "
                             f"{self.scene!r}")
        if self.sky_source not in self._SKY_SOURCES:
            raise ValueError(f"sky_source must be one of {self._SKY_SOURCES},"
                             f" got {self.sky_source!r}")
        if len(self.procedural_sky_shape) != 2 or any(
                v < 8 for v in self.procedural_sky_shape):
            raise ValueError(f"procedural_sky_shape must be (h, w) with both "
                             f">= 8, got {self.procedural_sky_shape!r}")
        if self.aspect is not None and not self.aspect > 0:
            raise ValueError(f"aspect must be positive, got {self.aspect}")
        if self.shard_interleave < 1:
            raise ValueError(f"shard_interleave must be >= 1, got "
                             f"{self.shard_interleave}")
