"""Procedural few-shot image datasets, numpy only: a copy of
`repro.data.fsl` (this package imports nothing of `repro`); the same
seeds give the same images. Nothing is downloaded.

* OmniglotLike -- handwritten-character analogue: each class is a fixed set
  of 3-6 strokes (random polylines); instances apply affine jitter + pixel
  noise before rasterisation. Single channel, paper geometry 28x28,
  964 train / 659 test classes available.
* CUBLike -- natural-image analogue: each class is a mixture of coloured
  2D Gaussian blobs over a textured background; instances jitter blob
  positions/scales. 3 channels, 84x84.

Both expose  class_images(class_id, n, rng_seed)  and an EpisodeSampler
producing N-way K-shot episodes with disjoint support/query instances.
Deterministic given (seed, episode index) => resumable meta-training.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _rasterize_strokes(strokes, size, thickness=1.2):
    """strokes: list of (P, 2) polyline points in [0,1]^2 -> (size, size)."""
    img = np.zeros((size, size), np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1)
    for pts in strokes:
        for a, b in zip(pts[:-1], pts[1:]):
            seg = b - a
            L = max(float(np.hypot(*seg)), 1e-6)
            n = max(int(L * size * 2), 2)
            ts = np.linspace(0, 1, n)[:, None]
            centers = a[None] + ts * seg[None]
            for c in centers:
                d2 = (yy - c[1]) ** 2 + (xx - c[0]) ** 2
                img += np.exp(-d2 * (size * thickness) ** 2 / 2)
    return np.clip(img, 0, 1)


class OmniglotLike:
    def __init__(self, n_classes: int, image_size: int = 28, seed: int = 0):
        self.n_classes = n_classes
        self.size = image_size
        self.seed = seed

    def _class_strokes(self, cid: int):
        rng = np.random.RandomState((self.seed * 9_999_991 + cid) % 2**31)
        strokes = []
        for _ in range(rng.randint(3, 7)):
            npts = rng.randint(2, 5)
            strokes.append(rng.uniform(0.12, 0.88, size=(npts, 2)))
        return strokes

    def class_images(self, cid: int, n: int, rng_seed: int) -> np.ndarray:
        """(n, H, W, 1) float32 instances of class cid."""
        base = self._class_strokes(cid)
        rng = np.random.RandomState((rng_seed * 7_654_321 + cid) % 2**31)
        out = np.zeros((n, self.size, self.size, 1), np.float32)
        for i in range(n):
            ang = rng.uniform(-0.25, 0.25)
            scale = rng.uniform(0.9, 1.1)
            shift = rng.uniform(-0.06, 0.06, size=2)
            R = scale * np.array([[np.cos(ang), -np.sin(ang)],
                                  [np.sin(ang), np.cos(ang)]])
            strokes = [(pts - 0.5) @ R.T + 0.5 + shift for pts in base]
            img = _rasterize_strokes(strokes, self.size)
            img += rng.randn(self.size, self.size).astype(np.float32) * 0.05
            out[i, :, :, 0] = np.clip(img, 0, 1)
        return out


class CUBLike:
    def __init__(self, n_classes: int, image_size: int = 84, seed: int = 0):
        self.n_classes = n_classes
        self.size = image_size
        self.seed = seed

    def class_images(self, cid: int, n: int, rng_seed: int) -> np.ndarray:
        crng = np.random.RandomState((self.seed * 31_337 + cid) % 2**31)
        k = crng.randint(3, 6)
        mus = crng.uniform(0.2, 0.8, size=(k, 2))
        sig = crng.uniform(0.05, 0.18, size=(k,))
        col = crng.uniform(0.1, 1.0, size=(k, 3))
        freq = crng.uniform(2, 8, size=2)
        rng = np.random.RandomState((rng_seed * 123_457 + cid) % 2**31)
        yy, xx = np.mgrid[0:self.size, 0:self.size].astype(np.float32)
        yy, xx = yy / self.size, xx / self.size
        out = np.zeros((n, self.size, self.size, 3), np.float32)
        for i in range(n):
            img = 0.15 * (1 + np.sin(freq[0] * np.pi * xx)
                          * np.sin(freq[1] * np.pi * yy))[..., None]
            img = np.repeat(img, 3, axis=-1)
            for j in range(k):
                m = mus[j] + rng.uniform(-0.08, 0.08, size=2)
                s = sig[j] * rng.uniform(0.85, 1.15)
                blob = np.exp(-((xx - m[0]) ** 2 + (yy - m[1]) ** 2)
                              / (2 * s * s))
                img += blob[..., None] * col[j]
            img += rng.randn(self.size, self.size, 3).astype(np.float32) * 0.04
            out[i] = np.clip(img, 0, 1)
        return out


@dataclasses.dataclass
class Episode:
    support_images: np.ndarray
    support_labels: np.ndarray   # in [0, n_way)
    query_images: np.ndarray
    query_labels: np.ndarray
    n_way: int
    class_ids: np.ndarray        # global class ids per way


class EpisodeSampler:
    def __init__(self, dataset, class_ids, n_way, k_shot, n_query=5, seed=0):
        self.ds = dataset
        self.class_ids = np.asarray(class_ids)
        self.n_way, self.k_shot, self.n_query = n_way, k_shot, n_query
        self.seed = seed

    def episode(self, index: int) -> Episode:
        rng = np.random.RandomState((self.seed * 48_611 + index) % 2**31)
        ways = rng.choice(self.class_ids, size=self.n_way, replace=False)
        s_imgs, s_lab, q_imgs, q_lab = [], [], [], []
        for w, cid in enumerate(ways):
            imgs = self.ds.class_images(int(cid), self.k_shot + self.n_query,
                                        rng_seed=index + 1)
            s_imgs.append(imgs[:self.k_shot])
            q_imgs.append(imgs[self.k_shot:])
            s_lab += [w] * self.k_shot
            q_lab += [w] * self.n_query
        return Episode(
            support_images=np.concatenate(s_imgs),
            support_labels=np.asarray(s_lab, np.int32),
            query_images=np.concatenate(q_imgs),
            query_labels=np.asarray(q_lab, np.int32),
            n_way=self.n_way, class_ids=ways)


def pretrain_batch(dataset, class_ids, batch: int, step: int, seed: int = 0):
    """Flat classification batches for HAT stage 1."""
    rng = np.random.RandomState((seed * 104_729 + step) % 2**31)
    cids = rng.choice(class_ids, size=batch)
    imgs, labels = [], []
    for c in cids:
        imgs.append(dataset.class_images(int(c), 1, rng_seed=step + 31)[0])
        labels.append(int(np.where(class_ids == c)[0][0]))
    return {"image": np.stack(imgs), "label": np.asarray(labels, np.int32)}
