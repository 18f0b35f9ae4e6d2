"""Headless point-cloud renderer (PNG frames), replacing the GLUT display
(mirror of `sph_sm_monodomain_tpu.utils.render`, `:20-223`, on the port's
states: tensors are brought to the host as numpy arrays first).

Replaces component C15 (/root/reference/main.cpp:40-352): same displacement
colormap (`set_color`, main.cpp:122-143), same displacement range
[-0.05, 0.05] (main.cpp:213), same post-stim fade ramp (main.cpp:221-222),
plus the voltage colormap the reference left commented out (main.cpp:210).
Renders with an orthographic camera (orbitable azimuth/elevation standing in
for the GLUT mouse orbit, main.cpp:354-381) into a numpy image buffer; no GL
required.
"""

from __future__ import annotations

import numpy as np

from ..config import SimConfig
from ..state import ParticleState


def _np(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def set_color(value, lo: float, hi: float) -> np.ndarray:
    """Blue->yellow->red ramp, exactly main.cpp:122-143 (value compared to
    mid_distance = (hi-lo)/2, NOT re-centered on lo — a reference quirk)."""
    value = np.asarray(value, dtype=np.float32)
    mid = (hi - lo) / 2.0
    ratio_lo = value / mid
    ratio_hi = (value - mid) / mid
    low = np.stack([ratio_lo, ratio_lo, 1.0 - ratio_lo], axis=-1)
    high = np.stack([np.ones_like(ratio_hi), 1.0 - ratio_hi,
                     np.zeros_like(ratio_hi)], axis=-1)
    rgb = np.where((value <= mid)[..., None], low, high)
    return np.clip(rgb, 0.0, 1.0)


def _project(pos: np.ndarray, azimuth: float, elevation: float,
             world: np.ndarray):
    """Orthographic orbit camera around the world center."""
    center = world / 2.0
    p = pos - center
    ca, sa = np.cos(azimuth), np.sin(azimuth)
    ce, se = np.cos(elevation), np.sin(elevation)
    x = p[:, 0] * ca + p[:, 2] * sa
    z = -p[:, 0] * sa + p[:, 2] * ca
    y = p[:, 1] * ce - z * se
    depth = p[:, 1] * se + z * ce
    return x, y, depth


def _draw_segment(img: np.ndarray, p0, p1, color, size: int,
                  half: float) -> None:
    """Rasterize one world-space segment (already camera-projected x/y
    pairs) by dense sampling — plenty for decoration lines."""
    n = 2 * size
    xs = np.linspace(p0[0], p1[0], n)
    ys = np.linspace(p0[1], p1[1], n)
    px = np.clip(((xs / half * 0.5 + 0.5) * (size - 1)).astype(np.int64),
                 0, size - 1)
    py = np.clip(((-ys / half * 0.5 + 0.5) * (size - 1)).astype(np.int64),
                 0, size - 1)
    img[py, px] = color


def _draw_world_decoration(img: np.ndarray, cfg: SimConfig, azimuth: float,
                           elevation: float, size: int,
                           half: float) -> None:
    """The reference display()'s world decoration (main.cpp:268-316):
    white wireframe world cube (display_cube, main.cpp:52-60/181-197) and
    the origin axes with the reference's color assignment — BLUE x, RED y,
    GREEN z (main.cpp:311-324, a quirk preserved verbatim)."""
    world = np.asarray(cfg.world_size, dtype=np.float32)
    wx, wy, wz = world

    def proj(pts):
        x, y, _ = _project(np.asarray(pts, np.float32), azimuth,
                           elevation, world)
        return np.stack([x, y], axis=1)

    c = np.array([[0, 0, 0], [wx, 0, 0], [wx, wy, 0], [0, wy, 0],
                  [0, 0, wz], [wx, 0, wz], [wx, wy, wz], [0, wy, wz]],
                 np.float32)
    cp = proj(c)
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7),
             (7, 4), (0, 4), (1, 5), (2, 6), (3, 7)]
    for a, b in edges:
        _draw_segment(img, cp[a], cp[b], (255, 255, 255), size, half)
    ax = proj([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    for end, color in ((1, (0, 0, 255)), (2, (255, 0, 0)),
                       (3, (0, 255, 0))):
        _draw_segment(img, ax[0], ax[end], color, size, half)


def render_points(state: ParticleState, cfg: SimConfig,
                  mode: str = "displacement", size: int = 600,
                  azimuth: float = 0.0, elevation: float = 0.0,
                  point_px: int = 2, fade_ratio: float = 1.0,
                  background=(26, 26, 26),
                  vrange: tuple[float, float] | None = None,
                  world_box: bool = False) -> np.ndarray:
    """Render active particles to an (size, size, 3) uint8 image.

    mode: 'displacement' (main.cpp:213, range [-0.05, 0.05], optionally
    scaled by `fade_ratio` like the post-stim ramp at main.cpp:221-222) or
    'voltage' (the commented-out variant at main.cpp:210, range
    [-200, max_voltage]).

    vrange: override the voltage colormap range. The reference's
    [-200, 200] maps an FHN wave's working range (tens of mV) onto a
    nearly-flat slice of the blue->yellow->red ramp; pass a tight range
    (e.g. (0, 15) for the apex-stim wave demo) to make the front visible.

    world_box: draw the reference display()'s decoration — white wireframe
    world cube + origin axes (blue x / red y / green z, its color quirk).
    """
    act = _np(state.active)
    pos = _np(state.pos)[act]
    if mode == "displacement":
        val = _np(state.displacement())[act] * fade_ratio
        rgb = set_color(val, -0.05, 0.05)
    elif mode == "voltage":
        lo, hi = vrange if vrange is not None else (-200.0, cfg.max_voltage)
        rgb = set_color(_np(state.vm)[act], lo, hi)
    else:
        raise ValueError(f"unknown render mode {mode!r}")

    world = np.asarray(cfg.world_size, dtype=np.float32)
    x, y, depth = _project(pos, azimuth, elevation, world)
    half = float(world.max()) * 0.75
    px = ((x / half * 0.5 + 0.5) * (size - 1)).astype(np.int64)
    py = ((-y / half * 0.5 + 0.5) * (size - 1)).astype(np.int64)

    img = np.zeros((size, size, 3), dtype=np.uint8)
    img[:] = background
    if world_box:
        # decoration first so particles paint over it (GL draws the cube
        # before the points in the same depth pass, main.cpp:289-291)
        _draw_world_decoration(img, cfg, azimuth, elevation, size, half)
    # painter's algorithm: back-to-front overwrite resolves occlusion
    order = np.argsort(depth)
    colors = (rgb * 255).astype(np.uint8)
    r = point_px // 2
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            qx = np.clip(px[order] + dx, 0, size - 1)
            qy = np.clip(py[order] + dy, 0, size - 1)
            img[qy, qx] = colors[order]
    return img


def save_png(path: str, img: np.ndarray) -> str:
    """Write `img` to `path`; returns the path actually written (the
    no-PIL fallback writes raw PPM and swaps the extension — callers must
    use the RETURNED path, not the requested one)."""
    try:
        from PIL import Image
        Image.fromarray(img).save(path)
    except ImportError:  # raw PPM fallback
        path = path.rsplit(".", 1)[0] + ".ppm"
        with open(path, "wb") as f:
            f.write(f"P6 {img.shape[1]} {img.shape[0]} 255\n".encode())
            f.write(img.tobytes())
    return path


def render_frames(states, cfg: SimConfig, out_dir: str, stim_off_step: int,
                  mode: str = "displacement", **kw) -> list:
    """Render a trajectory (list of states or (T,...) pos/vm dict) to PNGs,
    applying the reference's post-stim fade (main.cpp:221-222)."""
    import os
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, st in enumerate(states):
        fade = 1.0
        if 0 <= stim_off_step <= i and mode == "displacement":
            # ratio = 1 - 0.008 * (steps since stim off), main.cpp:221
            fade = max(0.0, 1.0 - 0.008 * (i - stim_off_step))
        img = render_points(st, cfg, mode=mode, fade_ratio=fade, **kw)
        p = save_png(os.path.join(out_dir, f"frame_{i:05d}.png"), img)
        paths.append(p)
    return paths


def render_mesh(state: ParticleState, cfg: SimConfig, faces: np.ndarray,
                mode: str = "displacement", size: int = 600,
                azimuth: float = 0.0, elevation: float = 0.0,
                light=(0.3, 0.8, 0.5), background=(26, 26, 26)) -> np.ndarray:
    """Flat-shaded triangle-mesh render (the reference's commented-out
    surface renderer, main.cpp:232-266): faces index particles directly;
    face color = mean vertex displacement/voltage through `set_color`,
    modulated by a Lambert term from the face normal."""
    try:
        from PIL import Image, ImageDraw
    except ImportError:
        return render_points(state, cfg, mode=mode, size=size,
                             azimuth=azimuth, elevation=elevation,
                             background=background)
    pos = _np(state.pos)
    world = np.asarray(cfg.world_size, dtype=np.float32)
    x, y, depth = _project(pos, azimuth, elevation, world)
    half = float(world.max()) * 0.75
    px = (x / half * 0.5 + 0.5) * (size - 1)
    py = (-y / half * 0.5 + 0.5) * (size - 1)

    if mode == "displacement":
        val = _np(state.displacement())
        rgb = set_color(val, -0.05, 0.05)
    else:
        rgb = set_color(_np(state.vm), -200.0, cfg.max_voltage)

    v0, v1, v2 = pos[faces[:, 0]], pos[faces[:, 1]], pos[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12)
    light = np.asarray(light) / np.linalg.norm(light)
    lambert = np.abs(fn @ light) * 0.7 + 0.3
    fcol = rgb[faces].mean(axis=1) * lambert[:, None]
    fdepth = depth[faces].mean(axis=1)

    img = Image.new("RGB", (size, size), tuple(background))
    draw = ImageDraw.Draw(img)
    for fi in np.argsort(fdepth):  # back to front
        i, j, k = faces[fi]
        c = tuple((np.clip(fcol[fi], 0, 1) * 255).astype(np.uint8))
        draw.polygon([(px[i], py[i]), (px[j], py[j]), (px[k], py[k])],
                     fill=c)
    return np.asarray(img)
