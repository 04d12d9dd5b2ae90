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
    chunk: int = 32768           # pixels per batch of the 'fast' and 'oracle'
    # paths (bounds their (chunk, objects) intermediates; never changes a
    # pixel)
    path: str = "auto"           # raytracer: 'auto' | 'fast' | 'oracle'.
    # 'auto' is the megakernel path on every device: the Engine's device
    # picks the CUDA kernels (a card) or their plain versions (the CPU).
    # 'fast' (render/fast.py) and 'oracle' (render/reference.py, the
    # parity ground truth) are plain PyTorch raytracers on either device.
    sky_cache: bool = True       # 'auto' path: static four-panorama stack,
    # pair blend at lookup time; False = blend + pack per frame, the
    # one-shot render_frame (a debug knob, bit-identical frames)
    scene: str = "island"        # 'island' | 'classic'
    antialiasing: bool = True    # FXAA default on (scene.cpp:24)
    sky_source: str = "procedural"  # 'reference' (the panoramas under
    # scene/textures.REFERENCE_BACKGROUNDS) | 'procedural' | 'auto'
    # (reference where that directory exists)
    sky_downsample: int = 1      # point-sample every k-th reference texel
    procedural_sky_shape: tuple = (2048, 4096)
    preview: int = 1             # windowed viewer: render at full size,
    # box-downsample by this factor on the device, read back the small
    # buffer and upscale in the blit (preview² fewer bytes per frame over
    # the device-to-host link). 1 = off.
    aspect: float | None = None  # None → width/height
    shard_interleave: int = 1    # sharded engines: strided sub-bands per
    # device (device d renders row chunks d, d+n, …); 1 = contiguous bands.
    # The frame is bit-identical either way.
    # NOTE: the reference initializes camera corners with aspect = 1.7777
    # (scene.cpp:20) and refreshes them only on mouse motion; set
    # aspect=1.7777 to reproduce that quirk.

    _PATHS = ("auto", "fast", "oracle")
    _SCENES = ("island", "classic")
    _SKY_SOURCES = ("auto", "reference", "procedural")

    def __post_init__(self):
        if self.width < 2 or self.height < 2:
            raise ValueError(f"framebuffer must be at least 2x2, got "
                             f"{self.width}x{self.height}")
        if self.chunk < 1:
            raise ValueError(f"chunk must be positive, got {self.chunk}")
        if self.path not in self._PATHS:
            raise ValueError(f"path must be one of {self._PATHS}, got "
                             f"{self.path!r}")
        if self.scene not in self._SCENES:
            raise ValueError(f"scene must be one of {self._SCENES}, got "
                             f"{self.scene!r}")
        if self.sky_source not in self._SKY_SOURCES:
            raise ValueError(f"sky_source must be one of {self._SKY_SOURCES},"
                             f" got {self.sky_source!r}")
        if self.sky_downsample < 1:
            raise ValueError(f"sky_downsample must be >= 1, got "
                             f"{self.sky_downsample}")
        if len(self.procedural_sky_shape) != 2 or any(
                v < 8 for v in self.procedural_sky_shape):
            raise ValueError(f"procedural_sky_shape must be (h, w) with both "
                             f">= 8, got {self.procedural_sky_shape!r}")
        if self.aspect is not None and not self.aspect > 0:
            raise ValueError(f"aspect must be positive, got {self.aspect}")
        if self.preview < 1:
            raise ValueError(f"preview must be >= 1, got {self.preview}")
        if self.preview > 1 and (self.width % self.preview
                                 or self.height % self.preview):
            raise ValueError(
                f"preview={self.preview} must divide the framebuffer "
                f"({self.width}x{self.height})")
        if self.shard_interleave < 1:
            raise ValueError(f"shard_interleave must be >= 1, got "
                             f"{self.shard_interleave}")
