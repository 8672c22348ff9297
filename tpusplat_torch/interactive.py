"""Interactive terminal viewer (counterpart of ``tpusplat/interactive.py``):
a keyboard-driven render loop with live metrics.

The analogue of the reference's defining user experience: the GLFW window
loop with WASD/cursor input (``src/vulkan/windowing/GLFWWindow.cpp:56-79``),
the ``Renderer::run`` frame loop (``src/Renderer.cpp:428-450``) and the
ImGui metrics overlay with frame times and the instance count
(``src/GUIManager.cpp:45-100``). The "window" is the terminal: frames are
sampled down to ANSI truecolor half-blocks (2 pixels per character cell)
and the overlay is a status line (frame ms, EMA fps, instances, overflow,
camera pose).

Input drives the Session hooks (``log_movement`` / ``log_translation``, the
reference's motion constants). The loop is scriptable: ``keys`` may be any
iterable, which is how the tests drive it without a tty.

Two differences from the JAX package: a frame's ms end at a synchronisation
of the card, so they include the device's work; and every frame feeds the
fps EMA, profiled ones too (the JAX loop skips profiled frames, so with
``profile_every=1`` its EMA never moves after the first frame).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

# Key map: WASD + e/c for up/down (GLFW Space/Shift, GLFWWindow.cpp:63-71),
# arrows for the cursor-delta rotation path (25 px per tap = 0.125 rad).
_MOVE_KEYS = {
    "w": (0.0, 0.0, -1.0),
    "s": (0.0, 0.0, 1.0),
    "a": (-1.0, 0.0, 0.0),
    "d": (1.0, 0.0, 0.0),
    "e": (0.0, 1.0, 0.0),
    "c": (0.0, -1.0, 0.0),
}
_ARROW_DELTAS = {
    "up": (0.0, -25.0),
    "down": (0.0, 25.0),
    "left": (-25.0, 0.0),
    "right": (25.0, 0.0),
}


def _sample(img, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """The [rows, cols, 3] sample of ``img`` at rows ``ys`` and columns
    ``xs``, on the host. A tensor is sampled on its device, so only the
    sample crosses to the host."""
    if isinstance(img, torch.Tensor):
        idx = [torch.from_numpy(a).to(img.device) for a in (ys, xs)]
        return img.detach().index_select(0, idx[0]).index_select(1, idx[1]).cpu().numpy()
    return np.asarray(img)[np.ix_(ys, xs)]


def ansi_frame(img, cols: int = 96) -> str:
    """Render [H, W, 3] floats (a tensor or an array) as ANSI truecolor
    half-blocks (2 rows a cell)."""
    h, w = img.shape[:2]
    cols = max(8, min(cols, w))
    rows = max(2, round(cols * h / w / 2) * 2)  # even: 2 pixel rows per cell
    ys = (np.arange(rows) * (h - 1) / max(rows - 1, 1)).astype(int)
    xs = (np.arange(cols) * (w - 1) / max(cols - 1, 1)).astype(int)
    px = np.clip(_sample(img, ys, xs) * 255.0, 0, 255).astype(np.uint8)
    out = []
    for r in range(0, rows, 2):
        line = []
        for cidx in range(cols):
            tr, tg, tb = px[r, cidx]
            br, bg, bb = px[r + 1, cidx]
            line.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀")
        out.append("".join(line) + "\x1b[0m")
    return "\n".join(out)


def _tty_keys(stop_flag):
    """Generator of keys from a raw-mode tty ('up'/'down'/... for arrows)."""
    import select
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setcbreak(fd)
        while not stop_flag():
            ready, _, _ = select.select([sys.stdin], [], [], 0.05)
            if not ready:
                yield None  # idle tick: redraw/refresh without input
                continue
            ch = sys.stdin.read(1)
            if ch == "\x1b":  # arrow escape sequence
                seq = sys.stdin.read(2)
                yield {"[A": "up", "[B": "down", "[D": "left", "[C": "right"}.get(seq, "esc")
            else:
                yield ch
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def run_interactive(
    session,
    keys=None,
    out=None,
    cols: int = 96,
    max_frames: int = 0,
    show_image: bool = True,
    profile_every: int = 8,
) -> dict:
    """Drive a Session interactively; returns summary stats.

    Args:
      session: an initialized (or initializable) ``tpusplat_torch.session.Session``.
      keys: iterable of key tokens ('w', 'a', ..., 'up', 'q', None=idle).
        Default: live keystrokes from the controlling tty.
      out: writable stream for frames/metrics (default stderr).
      max_frames: stop after N rendered frames (0 = until 'q'/keys end).
      profile_every: every Nth frame (never the first) renders stage by
        stage (``draw_profiled``) and refreshes the preprocess/bin+sort/
        raster ms in the overlay (0 = never). The live-stage-times analogue
        of the reference's timestamp-query GUI table
        (src/GUIManager.cpp:45-100).
    """
    out = out if out is not None else sys.stderr
    stopped = False
    if keys is None:
        keys = _tty_keys(lambda: stopped)

    session.initialize()
    frames = 0
    ema_ms = None
    stage_ms = None  # last sampled per-stage breakdown
    t_start = time.time()
    dirty = True
    for key in iter(keys):
        if key == "q" or key == "esc":
            break
        if key in _MOVE_KEYS:
            session.log_movement(*_MOVE_KEYS[key])
            dirty = True
        elif key in _ARROW_DELTAS:
            session.log_translation(*_ARROW_DELTAS[key])
            dirty = True
        elif key is not None:
            continue  # unknown key: don't burn a frame
        if not dirty:
            continue
        t0 = time.time()
        profiled = (profile_every
                    and frames > 0
                    and frames % profile_every == profile_every - 1
                    and hasattr(session, "draw_profiled"))
        if profiled:
            img, aux, stage_ms = session.draw_profiled()
        else:
            img, aux = session.draw()
        if img.device.type == "cuda":
            torch.cuda.synchronize(img.device)
        dt_ms = (time.time() - t0) * 1e3
        ema_ms = dt_ms if ema_ms is None else 0.8 * ema_ms + 0.2 * dt_ms
        frames += 1
        dirty = False
        if show_image:
            out.write("\x1b[H\x1b[2J" + ansi_frame(img, cols) + "\n")
        # The GUIManager metrics rows: per-stage times, fps, instance count
        # (src/GUIManager.cpp:45-100 text metrics + plot).
        pos = session.position
        if stage_ms is not None:
            out.write(
                "stages  " + "  ".join(f"{k} {v:6.1f} ms" for k, v in stage_ms.items())
                + ("  (sampling)" if not profiled else "  (live)") + "\n"
            )
        out.write(
            f"frame {frames}  {dt_ms:7.1f} ms  ema {ema_ms:7.1f} ms "
            f"({1e3 / max(ema_ms, 1e-6):5.1f} fps)  "
            f"instances {int(aux['num_instances'])}  "
            f"overflow {int(aux['capacity_overflow'])}  "
            f"pos ({pos[0]:+.2f} {pos[1]:+.2f} {pos[2]:+.2f})  "
            "[wasd/ec move, arrows look, q quit]\n"
        )
        out.flush()
        if max_frames and frames >= max_frames:
            break
    stopped = True
    return dict(
        frames=frames,
        seconds=time.time() - t_start,
        ema_ms=ema_ms,
        position=tuple(float(p) for p in session.position),
    )
