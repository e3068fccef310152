"""Visualisation helpers (port of ``dynamo_depth_tpu.utils.vis``; reference
``utils.py:81-164``), numpy on the host with the JAX package's channels-last
interface.

The flow colour wheel (``cart2polar`` and ``hsv_to_rgb``), score-map colour
mapping, the identity index map and mp4 writing, for ``eval/visualize.py``
and the quick demo. The colour maps come from ``utils/colormaps.py`` and the
geometry of :func:`vis_motion` from the port's float32 ``ops/geometry.py``,
so that no frame needs matplotlib. ``make_mp4`` writes PNG frames where no
mp4 encoder (imageio with ffmpeg or pyav) is installed, as the JAX package
does where imageio has no backend.
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch

from dynamo_depth_torch.ops.geometry import backproject, project
from dynamo_depth_torch.utils import colormaps
from dynamo_depth_torch.utils.io import join_dir


def make_ind_map(height, width):
    """Identity sample grid (1, H, W, 2) with corners [-1,-1]..[1,1]
    (utils.py:141-147). NOTE: normalized by dim (not dim-1), as reference."""
    v = np.arange(height, dtype=np.float32) / height * 2 - 1
    h = np.arange(width, dtype=np.float32) / width * 2 - 1
    grid = np.stack(np.meshgrid(h, v, indexing="xy"), axis=-1)  # (H, W, 2)
    return grid[None]


def cart2polar(cart):
    """(..., 2) [x, y] -> (r, theta) with the reference's quadrant convention
    (utils.py:149-161)."""
    assert cart.shape[-1] == 2
    r = np.sqrt(np.sum(cart ** 2, -1))
    with np.errstate(divide="ignore", invalid="ignore"):
        theta = np.arctan(cart[..., 0] / cart[..., 1])
    theta = np.nan_to_num(theta, nan=0.0)
    theta[cart[..., 1] < 0] += np.pi
    theta = (5 * np.pi / 2 - theta) % (2 * np.pi)
    return r, theta


def hsv_to_rgb(hsv):
    """(..., H, W, 3) channels-last hsv -> rgb (utils.py:163-189 semantics)."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0) % 6
    f = (h * 6.0) % 6 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = i.astype(np.int64)
    table = np.stack(
        [
            np.stack([v, q, p, p, t, v], -1),
            np.stack([t, v, v, q, p, p], -1),
            np.stack([p, p, t, v, v, q], -1),
        ],
        axis=-2,
    )  # (..., 3, 6)
    return np.take_along_axis(table, i[..., None, None].repeat(3, -2), axis=-1)[..., 0]


def _wheel_hsv(motion_xy, max_mag=None):
    """Colour-wheel hsv of (..., 2) motion, and the magnitude that maps to
    full value (the largest, where not given)."""
    mag, theta = cart2polar(motion_xy)
    if max_mag is None:
        max_mag = float(mag.max()) + 1e-8
    hsv = np.ones(motion_xy.shape[:-1] + (3,), dtype=np.float32)
    hsv[..., 0] = (theta - np.pi / 4) % (2 * np.pi) / (2 * np.pi)
    hsv[..., 1] = 1.0
    hsv[..., 2] = mag / max_mag
    return hsv, max_mag


def flow_vis(flow_xy, max_mag=None):
    """2D flow (..., H, W, 2) -> (rgb in [0,1], hsv, max_mag), matching the
    colorwheel construction of Trainer.py:596-605."""
    hsv, max_mag = _wheel_hsv(flow_xy, max_mag)
    return 1.0 - hsv_to_rgb(hsv), hsv, max_mag


def _norm_array(x):
    """A copy of ``x`` typed as matplotlib's ``Normalize.process_value``
    types it: floats keep their type, integers and bools become floats."""
    a = np.array(x)
    if np.issubdtype(a.dtype, np.integer) or a.dtype == np.bool_:
        return a.astype(np.promote_types(a.dtype, np.float32))
    return a


def score_map_vis(score_map, cmap="bone", vminmax=None, max_perc=95):
    """Colour-mapped score map -> rgb float array (utils.py:103-118), with
    matplotlib's ``Normalize`` arithmetic. ``cmap`` is ``"plasma"`` or
    ``"hot"``, the two the visualisations use."""
    sm = np.asarray(score_map).squeeze()
    if vminmax is None:
        vmin, vmax = sm.min(), np.percentile(sm, max_perc)
    else:
        vmin, vmax = vminmax
    vmin, vmax = _norm_array([vmin])[0], _norm_array([vmax])[0]
    x = _norm_array(sm)
    if vmin == vmax:
        x.fill(0)
    else:
        x -= vmin
        x /= vmax - vmin
    return colormaps.lookup(x, cmap)


def make_mp4(images, filename, fps=30, quality=8, macro_block_size=1, bgr=True):
    """Write frames to mp4 (utils.py:81-96), or to ``<name>_frames/*.png``
    where no mp4 encoder is installed. Returns the path written."""
    ext = osp.splitext(filename)[1]
    if ext == "":
        filename = filename + ".mp4"
    elif ext != ".mp4":
        raise ValueError(f"filename does not end with .mp4: `{filename}`")
    frames = np.stack(images, axis=0)
    if bgr:
        frames = frames[..., ::-1]
    try:
        import imageio

        imageio.mimwrite(filename, frames, fps=fps, quality=quality, macro_block_size=macro_block_size)
        return filename
    except Exception as e:
        from PIL import Image

        frame_dir = join_dir(osp.splitext(filename)[0] + "_frames")
        for i, fr in enumerate(frames):
            Image.fromarray(fr).save(osp.join(frame_dir, f"{i:06}.png"))
        print(f"mp4 encode unavailable ({e}); wrote {len(frames)} PNG frames to {frame_dir}")
        return frame_dir


def vis_motion(depth, K, inv_K, motion_map=None, camTcam=None):
    """Optical-flow colour-wheel inputs from depth and motion
    (Trainer.py:574-605), in float32.

    depth: (B, H, W, 1); motion_map: (B, H, W, 3) or None; camTcam: (B, 4, 4)
    or None (numpy). Returns (hsv (B, H, W, 3), max_mag). The projection
    error at T=None is subtracted as in the reference.
    """
    B, h, w, _ = depth.shape

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32))

    ind_map = make_ind_map(h, w)  # (1, H, W, 2)
    pts = backproject(f32(depth)[..., 0], f32(inv_K))
    pix_id, _ = project(pts, f32(K), None, height=h, width=w)
    err = pix_id.numpy() - ind_map

    moved = pts if motion_map is None else pts + f32(motion_map).reshape(B, h * w, 3)
    T = None if camTcam is None else f32(camTcam)
    pix, _ = project(moved, f32(K), T, height=h, width=w)
    return _wheel_hsv(pix.numpy() - ind_map - err)
