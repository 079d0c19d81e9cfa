"""Synthetic stand-ins for the paper's four data sets (Table 1) — a numpy
copy of ``repro.data.synthetic``: the same seed gives the same arrays.

  · road3d     — 3D Road Network (434,874 × 4): points along noisy road
                 polylines (lon/lat/alt + curvature).
  · skin       — Skin Segmentation (245,057 × 4): two BGR blob families
                 (skin tones vs. background) + luminance.
  · poker      — Poker Hand (1,025,010 × 11): 5× (suit, rank) + hand class
                 proxy; integer-valued, weakly clustered — the hard case.
  · spacenet   — SpaceNet imagery: [n_img, 438, 406, 3] spectral images with
                 k_true smooth regions (forest/water/road/… analogue).

Generators are deterministic in ``seed`` and accept ``n`` overrides so tests
run at reduced scale.
"""
from __future__ import annotations

import numpy as np

PAPER_SIZES = {"road3d": 434_874, "skin": 245_057, "poker": 1_025_010}
SPACENET_IMAGE_SHAPE = (438, 406, 3)


def road3d(n: int = 50_000, seed: int = 0) -> np.ndarray:
    """Points scattered along a handful of noisy polyline 'roads'."""
    rng = np.random.default_rng(seed)
    n_roads = 12
    pts = []
    per = n // n_roads
    for r in range(n_roads):
        t = rng.uniform(0, 1, size=(per,))
        start = rng.uniform([8.0, 56.5, 0.0], [10.5, 57.8, 60.0])
        end = rng.uniform([8.0, 56.5, 0.0], [10.5, 57.8, 60.0])
        base = start[None, :] + t[:, None] * (end - start)[None, :]
        wiggle = 0.02 * np.stack([np.sin(9 * t + r), np.cos(7 * t + r),
                                  5 * np.sin(3 * t)], axis=-1)
        xyz = base + wiggle + rng.normal(0, [0.004, 0.004, 1.5], size=(per, 3))
        curv = np.abs(np.gradient(xyz[:, 2])) + rng.normal(0, 0.1, per)
        pts.append(np.concatenate([xyz, curv[:, None]], axis=-1))
    out = np.concatenate(pts)[:n].astype(np.float32)
    return out[rng.permutation(out.shape[0])]


def skin(n: int = 50_000, seed: int = 0) -> np.ndarray:
    """Two BGR families: skin-tone manifold vs. broad background."""
    rng = np.random.default_rng(seed)
    n_skin = n // 2
    tone = rng.beta(2.0, 1.5, size=(n_skin, 1))
    skin_bgr = np.concatenate([
        120 + 60 * tone + rng.normal(0, 12, (n_skin, 1)),     # B
        140 + 70 * tone + rng.normal(0, 12, (n_skin, 1)),     # G
        180 + 70 * tone + rng.normal(0, 12, (n_skin, 1)),     # R
    ], axis=-1)
    n_bg = n - n_skin
    centers = rng.uniform(0, 255, size=(8, 3))
    which = rng.integers(0, 8, size=n_bg)
    bg = centers[which] + rng.normal(0, 25, (n_bg, 3))
    bgr = np.clip(np.concatenate([skin_bgr, bg]), 0, 255)
    lum = bgr @ np.array([0.114, 0.587, 0.299])
    out = np.concatenate([bgr, lum[:, None]], axis=-1).astype(np.float32)
    return out[rng.permutation(n)]


def poker(n: int = 50_000, seed: int = 0) -> np.ndarray:
    """5 cards × (suit 1–4, rank 1–13) + weak hand-type signal (11 attrs)."""
    rng = np.random.default_rng(seed)
    suits = rng.integers(1, 5, size=(n, 5)).astype(np.float32)
    ranks = rng.integers(1, 14, size=(n, 5)).astype(np.float32)
    # weak class-correlated structure: pairs share ranks
    has_pair = rng.random(n) < 0.42
    ranks[has_pair, 1] = ranks[has_pair, 0]
    cards = np.empty((n, 10), np.float32)
    cards[:, 0::2] = suits
    cards[:, 1::2] = ranks
    hand = has_pair.astype(np.float32) + (ranks.max(1) > 11)
    return np.concatenate([cards, hand[:, None]], axis=-1)


def spacenet_images(n_images: int = 4, k_true: int = 6, seed: int = 0,
                    shape: tuple[int, int, int] = SPACENET_IMAGE_SHAPE) -> np.ndarray:
    """[n_img, H, W, 3] images of k_true spatially-smooth spectral regions."""
    rng = np.random.default_rng(seed)
    h, w, c = shape
    # fixed spectral signatures (forest, water, road, building, grass, waste)
    sigs = np.array([[40, 90, 40], [20, 40, 90], [90, 90, 95],
                     [150, 130, 120], [90, 140, 60], [130, 110, 80]],
                    np.float32)[:k_true]
    imgs = np.empty((n_images, h, w, c), np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(n_images):
        # smooth label field via low-frequency random mixtures
        field = np.zeros((h, w, k_true), np.float32)
        for k in range(k_true):
            for _ in range(3):
                fy, fx = rng.uniform(0.5, 3.0, 2)
                py, px = rng.uniform(0, 2 * np.pi, 2)
                field[:, :, k] += rng.uniform(0.4, 1.0) * np.sin(
                    2 * np.pi * fy * yy / h + py) * np.cos(2 * np.pi * fx * xx / w + px)
        labels = field.argmax(-1)
        img = sigs[labels] + rng.normal(0, 9.0, (h, w, c))
        imgs[i] = np.clip(img, 0, 255)
    return imgs


def spacenet_pixels(n_images: int = 4, k_true: int = 6, seed: int = 0,
                    shape=SPACENET_IMAGE_SHAPE) -> np.ndarray:
    """Flattened per-image pixel groups: [n_img, H·W, 3] (image = group, §5.2)."""
    imgs = spacenet_images(n_images, k_true, seed, shape)
    n, h, w, c = imgs.shape
    return imgs.reshape(n, h * w, c)


DATASETS = {"road3d": road3d, "skin": skin, "poker": poker}


def load(name: str, n: int | None = None, seed: int = 0) -> np.ndarray:
    if name in DATASETS:
        kwargs = {"seed": seed}
        if n is not None:
            kwargs["n"] = n
        return DATASETS[name](**kwargs)
    raise KeyError(f"unknown dataset {name!r}; choose from {sorted(DATASETS)} "
                   f"or use spacenet_pixels()")
