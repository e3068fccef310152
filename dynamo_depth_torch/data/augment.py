"""Numpy color-jitter augmentation.

Reproduces torchvision ``ColorJitter(brightness=(0.8,1.2), contrast=(0.8,1.2),
saturation=(0.8,1.2), hue=(-0.1,0.1))`` as used by the reference
(``datasets/base_dataset.py:61-72``): factors drawn uniformly, the four ops
applied in a random order, and the *same* sampled transform applied to every
frame of a triplet (base_dataset.py:83-94). The port's copy of
``dynamo_depth_tpu.data.augment``: the same numpy draws in the same order,
so both packages jitter an item alike from one seed.
"""

from __future__ import annotations

import numpy as np

_GRAY = np.array([0.299, 0.587, 0.114], dtype=np.float32)


def _blend(a, b, factor):
    return np.clip(factor * a + (1.0 - factor) * b, 0.0, 1.0)


def adjust_brightness(img, factor):
    return _blend(img, np.zeros_like(img), factor)


def adjust_contrast(img, factor):
    # torchvision: blend with the mean of the grayscale image.
    mean = (img @ _GRAY).mean(dtype=np.float32)
    return _blend(img, np.full_like(img, mean), factor)


def adjust_saturation(img, factor):
    gray = (img @ _GRAY)[..., None]
    return _blend(img, np.broadcast_to(gray, img.shape), factor)


def _rgb_to_hsv(img):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = np.max(img, axis=-1)
    minc = np.min(img, axis=-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    rc = np.where(delta > 0, (maxc - r) / np.maximum(delta, 1e-12), 0.0)
    gc = np.where(delta > 0, (maxc - g) / np.maximum(delta, 1e-12), 0.0)
    bc = np.where(delta > 0, (maxc - b) / np.maximum(delta, 1e-12), 0.0)
    h = np.where(maxc == r, bc - gc, np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    return h, s, v


def _hsv_to_rgb(h, s, v):
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    out = np.choose(
        i[..., None],
        [
            np.stack([v, t, p], -1), np.stack([q, v, p], -1), np.stack([p, v, t], -1),
            np.stack([p, q, v], -1), np.stack([t, p, v], -1), np.stack([v, p, q], -1),
        ],
        mode="clip",
    )
    return out


def adjust_hue(img, factor):
    h, s, v = _rgb_to_hsv(img)
    h = (h + factor) % 1.0
    return _hsv_to_rgb(h, s, v).astype(img.dtype)


class ColorJitter:
    """Sample once with :meth:`sample`, apply to many frames."""

    def __init__(self, brightness=(0.8, 1.2), contrast=(0.8, 1.2),
                 saturation=(0.8, 1.2), hue=(-0.1, 0.1)):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def sample(self, rng: np.random.RandomState):
        order = rng.permutation(4)
        factors = {
            0: rng.uniform(*self.brightness),
            1: rng.uniform(*self.contrast),
            2: rng.uniform(*self.saturation),
            3: rng.uniform(*self.hue),
        }

        fns = {0: adjust_brightness, 1: adjust_contrast, 2: adjust_saturation, 3: adjust_hue}

        def apply(img):
            out = img
            for op in order:
                out = fns[int(op)](out, factors[int(op)])
            return out

        return apply
