"""Interactive window: pygame display + input → Action mapping (port of
raytracing_cuda_tpu/app/window.py).

Replacement for the reference's GLUT/Win32 shell (main.cpp:338-443,
scene.cpp:689-756): instead of a CUDA-GL interop PBO the frame is rendered
by the Engine on its device and blitted from a host array; instead of
per-frame Win32 GetAsyncKeyState polling, pygame's key state snapshot feeds
the sim.animate step. Controls follow the reference README:

  mouse        look (pointer captured; ESC quits)      scene.cpp:128-140
  W/A/S/D      move, Q/E up/down, SHIFT run            scene.cpp:142-163
  LEFT/RIGHT   scrub time of day (x4 speed)            scene.cpp:691-698
  O / P        pause / play the day cycle              scene.cpp:700-706
  UP/DOWN      raise / lower sea level                 scene.cpp:708-712
  1/2/3/4      time presets (morning/day/evening/night) scene.cpp:713-728
  5 / 6        camera presets (island / mountains)     scene.cpp:736-747
  B / V        FXAA on / off                           scene.cpp:750-755
  F            toggle fullscreen                       main.cpp:277-284
  F5 / F9      save / load state checkpoint (the reference rebuilds all
               state at startup, scene.cpp:654)
  F12          screenshot: the current state at full size
  ESC          quit                                    main.cpp:286-289

The window title shows FPS and the HH:MM clock like the reference's
`timerEvent` (main.cpp:230-237) and `getTime` (scene.cpp:731-733).

pygame is imported inside run_window only, so this module (poll_action,
Readback) imports without it.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from raytracing_cuda_tpu_torch.app.loop import Engine
from raytracing_cuda_tpu_torch.sim.actions import Action
from raytracing_cuda_tpu_torch.utils.checkpoint import load_state, save_state
from raytracing_cuda_tpu_torch.utils.config import RenderConfig
from raytracing_cuda_tpu_torch.utils import profiling
from raytracing_cuda_tpu_torch.utils.images import save_png

CHECKPOINT = "raytracer_state.json"


def poll_action(pygame, grab: bool) -> Action:
    """Build this frame's Action from pygame's key/mouse state."""
    k = pygame.key.get_pressed()
    K = pygame.K_d, pygame.K_a, pygame.K_w, pygame.K_s, pygame.K_q, pygame.K_e
    d, a, w, s, q, e = (np.int32(1) if k[x] else np.int32(0) for x in K)
    mdx, mdy = pygame.mouse.get_rel() if grab else (0, 0)

    def preset(keys):
        for i, key in enumerate(keys):
            if k[key]:
                return np.int32(i)
        return np.int32(-1)

    return Action(
        move_side=d - a, move_forward=w - s, move_up=q - e,
        run=np.bool_(k[pygame.K_LSHIFT] or k[pygame.K_RSHIFT]),
        mouse_dx=np.float32(mdx), mouse_dy=np.float32(mdy),
        time_control=(np.int32(1) if k[pygame.K_RIGHT] else np.int32(0))
        - (np.int32(1) if k[pygame.K_LEFT] else np.int32(0)),
        set_play=np.bool_(k[pygame.K_p]), set_pause=np.bool_(k[pygame.K_o]),
        sea_control=(np.int32(1) if k[pygame.K_UP] else np.int32(0))
        - (np.int32(1) if k[pygame.K_DOWN] else np.int32(0)),
        time_preset=preset((pygame.K_1, pygame.K_2, pygame.K_3, pygame.K_4)),
        cam_preset=preset((pygame.K_5, pygame.K_6)),
        set_aa_on=np.bool_(k[pygame.K_b]), set_aa_off=np.bool_(k[pygame.K_v]),
    )


class Readback:
    """Device-to-host readback one frame behind: `submit(frame)` starts
    frame i's copy into pinned host memory without waiting for it and hands
    back frame i - 1 on the host, so the blit of one frame overlaps the
    render and transfer of the next.

    Two pinned buffers take the copies in turn, each with a CUDA event
    recorded behind its copy; a buffer is allocated anew when the frame's
    shape changes (a resize). The tensor handed back is the buffer itself:
    it holds frame i - 1 until the submit after next, which copies frame
    i + 1 into it, so the caller is done with it (blitted or copied) before
    then. A frame that is already on the host is handed back as it is.

    While a torch.profiler session records, the copy's enqueue and the
    wait for a copy are host spans of the trace (`readback.copy`,
    `readback.wait`; utils/profiling.py).
    """

    def __init__(self):
        self._slots = [None, None]     # (pinned buffer, copy-done event)
        self._n = 0
        self._pending = None           # (host tensor, event or None)

    def _start_copy(self, frame: torch.Tensor):
        slot = self._slots[self._n % 2]
        if slot is None or slot[0].shape != frame.shape:
            slot = self._slots[self._n % 2] = (
                torch.empty(frame.shape, dtype=frame.dtype, pin_memory=True),
                torch.cuda.Event())
        self._n += 1
        host, copied = slot
        host.copy_(frame, non_blocking=True)
        copied.record(torch.cuda.current_stream(frame.device))
        return slot

    def submit(self, frame: torch.Tensor):
        """Start `frame`'s readback; → the frame submitted before it, on
        the host (None for the first)."""
        span = profiling.span_function()
        with span("readback.copy"):
            pending = ((frame, None) if frame.device.type == "cpu"
                       else self._start_copy(frame))
        previous, self._pending = self._pending, pending
        return self._wait(previous, span)

    def flush(self):
        """→ the pending frame on the host (None when there is none), which
        is then pending no more: the last frame of a loop, or one dropped
        at a resize."""
        pending, self._pending = self._pending, None
        return self._wait(pending, profiling.span_function())

    @staticmethod
    def _wait(pending, span):
        if pending is None:
            return None
        host, copied = pending
        with span("readback.wait"):
            if copied is not None:
                copied.synchronize()
        return host


def _screenshot_path() -> str:
    """screenshot_<time>.png; strftime has 1-second resolution, so a
    counter keeps two shots of one second apart."""
    stem = time.strftime("screenshot_%Y%m%d_%H%M%S")
    shot, n = f"{stem}.png", 1
    while os.path.exists(shot):
        shot, n = f"{stem}_{n}.png", n + 1
    return shot


def run_window(config: RenderConfig, device, max_frames: int | None = None,
               resize_settle_s: float = 0.35, initial_state=None) -> int:
    """Open the interactive viewer on an Engine(config, device). Blocks
    until ESC / window close; returns the number of frames rendered.

    max_frames bounds the loop for smoke tests on machines with no display
    (with SDL_VIDEODRIVER=dummy). resize_settle_s debounces live
    window resizes: a drag emits a stream of VIDEORESIZE events, and the
    engine is rebuilt only once the size has been stable for this long.
    """
    import pygame

    engine = Engine(config, device)
    if initial_state is not None:      # CLI --state/--day/--cam/--no-aa
        engine.set_state(initial_state)

    pygame.init()
    screen = pygame.display.set_mode((config.width, config.height),
                                     pygame.RESIZABLE)
    pygame.display.set_caption("raytracing_cuda_tpu_torch")
    grab = pygame.display.get_driver() != "dummy"
    if grab:
        pygame.mouse.set_visible(False)        # main.cpp:430 hides the cursor
        pygame.event.set_grab(True)
        pygame.mouse.get_rel()                 # swallow the initial jump

    fullscreen = False
    readback = Readback()
    resize_target = None    # debounced live-resize request
    resize_t = 0.0
    last = time.perf_counter()
    fps_n, fps_t0 = 0, last
    frames = 0
    running = True
    while running and (max_frames is None or frames < max_frames):
        for ev in pygame.event.get():
            if ev.type == pygame.QUIT:
                running = False
            elif ev.type == pygame.KEYDOWN:
                if ev.key == pygame.K_ESCAPE:
                    running = False
                elif ev.key == pygame.K_f:     # fullscreen toggle
                    fullscreen = not fullscreen
                    flags = (pygame.FULLSCREEN if fullscreen
                             else pygame.RESIZABLE)
                    screen = pygame.display.set_mode(
                        (config.width, config.height), flags)
                    resize_target = None   # mode switches emit VIDEORESIZE;
                    #                        they are not live resizes
                elif ev.key == pygame.K_F5:
                    save_state(engine.state, CHECKPOINT)
                elif ev.key == pygame.K_F9:
                    try:
                        engine.set_state(load_state(CHECKPOINT))
                    except (FileNotFoundError, ValueError) as e:
                        # a missing or corrupt checkpoint must not end the
                        # viewer; keep the current state
                        print(f"checkpoint load skipped: {e}")
                elif ev.key == pygame.K_F12:
                    # the current state at full size, whatever the preview
                    shot = _screenshot_path()
                    save_png(engine.frame_np(), shot)
                    print(f"saved {shot}")
            elif ev.type == pygame.VIDEORESIZE and not fullscreen:
                # live resolution change (reshape, main.cpp:293-306):
                # record the target; the rebuild happens below once the
                # size stops changing. Snapped to multiples of the preview
                # factor so the downsample stays exact.
                p = engine.config.preview
                resize_target = (max(ev.w, 2 * p) // p * p,
                                 max(ev.h, 2 * p) // p * p)
                resize_t = time.perf_counter()

        if (resize_target is not None
                and time.perf_counter() - resize_t >= resize_settle_s):
            w, h = resize_target
            resize_target = None
            if (w, h) != (engine.config.width, engine.config.height):
                engine = engine.resized(w, h)
                config = engine.config
                readback.flush()               # a frame of the old size
                screen = pygame.display.set_mode((w, h), pygame.RESIZABLE)

        now = time.perf_counter()
        dt, last = now - last, now             # updateDelta, main.cpp:255-258
        # clamp: a long stall (a kernel build at the first frame, a live
        # resize) must not become one giant sim step
        dt = min(dt, 0.1)
        # double-buffered present: enqueue this frame's render and start
        # its copy to the host, then blit the previous frame while the
        # device works
        p = engine.config.preview
        step = (engine.step_and_frame_preview if p > 1
                else engine.step_and_frame)
        shown = readback.submit(step(poll_action(pygame, grab), dt))
        if shown is not None:
            # make_surface copies the (W, H, 3) view into the surface
            surf = pygame.surfarray.make_surface(
                shown.numpy().transpose(1, 0, 2))
            full = (surf.get_width() * p, surf.get_height() * p)
            if full == screen.get_size():
                if p > 1:   # preview: upscale the small readback in the blit
                    surf = pygame.transform.scale(surf, full)
                screen.blit(surf, (0, 0))
                pygame.display.flip()
        frames += 1

        # FPS + clock in the title every 0.5 s (REFRESH_DELAY, main.cpp:32):
        # frames over the window, not the mean of instantaneous 1/dt rates
        fps_n += 1
        if now - fps_t0 >= 0.5:
            pygame.display.set_caption(
                f"raytracing_cuda_tpu_torch   {fps_n / (now - fps_t0):5.1f} "
                f"fps   {engine.time_string()}")
            fps_n, fps_t0 = 0, now

    pygame.quit()
    return frames
