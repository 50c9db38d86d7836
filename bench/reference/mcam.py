"""Plain reference of the MCAM store and its searches, written from the
paper's semantics (arXiv:2409.07832 Sec. 3) in plain PyTorch.

It imports nothing of the program under test. The benchmark hands it the
float supports, labels, writes and queries it made from the seed, and it
works out everything else again: the calibrated range, the quantised
words, the ring state after each write, the ideal AVSS distances, the
shortlist, the noisy string currents and their votes, and the predicted
labels.

Semantics, per query b (its position in the batch), store row n, string s
of S = seg * L (segment seg of `string_len` dimensions, code word c) and
cell j of the string:

    m       = |q[seg * sl + j] - code_c(v[n, seg * sl + j])|  (pad dims: 0)
    sid     = (n * S + s) mod 2**32
    dev     = normal(b, sid, j; seed)
    m_eff   = clip(m + sigma_device * dev, 0, 3)
    R       = sum over j, in cell order, of exp(m_eff * f32(log rho))
    I       = sl / R * (1 + sigma_read * normal(b, sid; seed + 0x2C1B))
    votes  += w_c * #(I > thresholds)
    dist   += w_c * sum_j m

`normal` is Box-Muller over a counter hash of the coordinates (a
murmur3 finaliser chained over them). Distances are integers below 2**24,
so float32 holds them exactly; the ranking is by (distance, row), and
rows of label -1 (never written) rank last and carry MASK_PENALTY.

A partitioned store (n_shards contiguous blocks of rows) is searched by
routing: per shard, int32 sums and counts of the valid rows' words in
each bucket `label % ROUTER_BUCKETS`; each bucket's integer centroid, the
mean rounded half up in the level domain; each query's score of a shard,
the least LUT distance from its words to the shard's buckets, an empty
bucket at MASK_PENALTY; the nprobe smallest scores, ties to the lower
shard id, visited in ascending id. Phase 1 then ranks only the visited
shards' rows, by the same (distance, global row), and phase 2 rescores
them at their global rows.

`dtype` is the precision of the float stages. float32 is the
configuration's; bfloat16 is the control, which must come out wrong.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CELL_STATES = 4
U32 = 0xFFFFFFFF
_M1, _M2 = 0x7FEB352D, 0x846CA68B
_GOLDEN, _SEED_ADD = 0x9E3779B9, 0x85EBCA6B
NORMAL_OFFSET = 0x5BD1
READ_OFFSET = 0x2C1B
INV_2_32 = float(np.float32(1.0 / 4294967296.0))
TWO_PI = float(np.float32(2.0 * np.float32(np.pi)))
#: added to the distance of a never-written row, which ranks after every
#: written one (the retrieval API's documented value)
MASK_PENALTY = 2.0 ** 22
#: cells of one block of the physics (bounds the reference's memory)
BLOCK_CELLS = 1 << 25
#: class buckets of a shard's routing sketch (label % ROUTER_BUCKETS)
ROUTER_BUCKETS = 8
#: the key of a row that a routed query does not visit: after every other
NOT_VISITED = (1 << 63) - 1


def f32(x: float) -> float:
    return float(np.float32(x))


# -- encodings ----------------------------------------------------------------


def code_length(name: str, cl: int) -> int:
    if name == "b4we":
        return (CELL_STATES ** cl - 1) // 3
    return cl


def levels(name: str, cl: int) -> int:
    if name == "mtmc":
        return 3 * cl + 1
    if name == "sre":
        return CELL_STATES
    return CELL_STATES ** cl


def word_weights(name: str, cl: int) -> list[float]:
    if name == "b4e":
        return [float(CELL_STATES ** (cl - 1 - i)) for i in range(cl)]
    if name == "b4we":
        return [1.0] * code_length(name, cl)
    return [1.0] * cl


def codes(v: torch.Tensor, name: str, cl: int) -> torch.Tensor:
    """Integer values (...) -> code words (..., L) in [0, 3]."""
    v = v.to(torch.int64)
    if name == "mtmc":
        # value m: the last m mod cl words hold m // cl + 1, the others m // cl
        c = torch.arange(cl, device=v.device)
        word = (v // cl)[..., None] + (c >= (cl - v % cl)[..., None])
        return word.clamp(0, CELL_STATES - 1)
    if name == "sre":
        return v[..., None].expand(*v.shape, cl)
    digits = torch.stack([(v // CELL_STATES ** (cl - 1 - i)) % CELL_STATES
                          for i in range(cl)], -1)
    if name == "b4e":
        return digits
    if name == "b4we":
        return torch.cat([digits[..., i:i + 1].expand(
            *v.shape, CELL_STATES ** (cl - 1 - i)) for i in range(cl)], -1)
    raise ValueError(f"reference: no encoding {name!r}")


def sum_lut(name: str, cl: int) -> np.ndarray:
    """(4, levels) float64: the weighted mismatch of query word q against
    stored value v, sum_c w_c |q - code_c(v)|."""
    c = codes(torch.arange(levels(name, cl)), name, cl).numpy()  # (lv, L)
    w = np.asarray(word_weights(name, cl))
    q = np.arange(CELL_STATES)[:, None, None]
    return (np.abs(q - c[None]) * w).sum(-1)


def thresholds(string_len: int, rho: float, n: int) -> np.ndarray:
    """The sense amplifier's reference currents, ascending float32: the
    ideal currents of strings with s single-level mismatches, s spaced
    geometrically from 1 to 1.5 string lengths."""
    s = np.unique(np.round(np.geomspace(1.0, 1.5 * string_len, n)))
    while len(s) < n:
        s = np.unique(np.concatenate([s, s[-1:] + np.arange(1, 1 + n - len(s))]))
    s = s[:n].astype(np.float64)
    return np.sort(string_len / ((string_len - s) + s * rho)).astype(np.float32)


# -- calibration and quantisation -----------------------------------------------


def clip_range(x: torch.Tensor, clip_std: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 (lo, hi): mean -/+ clip_std population standard deviations,
    clamped to the data's extent."""
    mu = x.mean()
    sd = x.std(correction=0) + 1e-8
    lo = torch.maximum(mu - clip_std * sd, x.min())
    hi = torch.minimum(mu + clip_std * sd, x.max() + 1e-8)
    return lo, hi


def quantize(x: torch.Tensor, n_levels: int, lo: torch.Tensor,
             hi: torch.Tensor) -> torch.Tensor:
    """Clip to [lo, hi], scale by (n_levels - 1) / (hi - lo), round half
    to even, clamp to [0, n_levels), in x's dtype; int64 words (NaN, from
    hi == lo, to 0)."""
    scale = torch.full((), float(n_levels - 1), dtype=x.dtype,
                       device=x.device) / (hi - lo)
    q = torch.round((torch.minimum(torch.maximum(x, lo), hi) - lo) * scale)
    q = torch.clamp(q, 0.0, float(n_levels - 1))
    return torch.nan_to_num(q, nan=0.0).to(torch.int64)


# -- the store ------------------------------------------------------------------


class Store:
    """The ring of quantised supports: words (N, d) int64, labels (N,)
    int64 (-1: never written), size (writes so far), the calibrated (lo,
    hi), calibrated and quantised in `dtype`."""

    def __init__(self, cfg: dict, device, dtype=torch.float32):
        self.cfg, self.dtype = cfg, dtype
        self.enc, self.cl = cfg["encoding"], cfg["cl"]
        n, d = cfg["capacity"], cfg["dim"]
        self.words = torch.zeros(n, d, dtype=torch.int64, device=device)
        self.labels = torch.full((n,), -1, dtype=torch.int64, device=device)
        self.size = 0
        self.lo = self.hi = None
        self._sketch: tuple | None = None

    def calibrate(self, sample: torch.Tensor) -> None:
        self.lo, self.hi = clip_range(sample.to(self.dtype),
                                      self.cfg["clip_std"])

    def write(self, x: torch.Tensor, labels: torch.Tensor) -> None:
        n, ring = x.shape[0], self.words.shape[0]
        idx = (self.size + torch.arange(n, device=x.device)) % ring
        self.words[idx] = quantize(x.to(self.dtype),
                                   levels(self.enc, self.cl), self.lo, self.hi)
        self.labels[idx] = labels.to(torch.int64)
        self.size += n

    def query_words(self, q: torch.Tensor) -> torch.Tensor:
        """AVSS queries: one 4-level word a dimension."""
        return quantize(q.to(self.dtype), CELL_STATES, self.lo, self.hi)

    def sketch(self, n_shards: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The routing sketch of the ring as it stands: per (shard,
        bucket), the sums (S, R, d) of the valid rows' words and their
        counts (S, R), int64 (every sum fits in int32), worked out again
        after each write."""
        if self._sketch is None or self._sketch[:2] != (self.size, n_shards):
            n, d = self.words.shape
            rows = torch.arange(n, device=self.words.device)
            valid = self.labels >= 0
            cell = ((rows // (n // n_shards)) * ROUTER_BUCKETS
                    + self.labels % ROUTER_BUCKETS)[valid]
            cells = n_shards * ROUTER_BUCKETS
            sums = torch.zeros(cells, d, dtype=torch.int64,
                               device=self.words.device)
            sums.index_add_(0, cell, self.words[valid])
            counts = torch.bincount(cell, minlength=cells)
            self._sketch = (self.size, n_shards,
                            sums.reshape(n_shards, ROUTER_BUCKETS, d),
                            counts.reshape(n_shards, ROUTER_BUCKETS))
        return self._sketch[2], self._sketch[3]


# -- phase 1: ideal distances and the shortlist -----------------------------------


def distances(qw: torch.Tensor, words: torch.Tensor, enc: str, cl: int,
              dtype=torch.float32) -> torch.Tensor:
    """(B, n) ideal AVSS distances: the one-hot query against the LUT
    projection of each row, as one matrix product (exact in float32 with
    TF32 off; `dtype` for the control)."""
    lut = torch.as_tensor(sum_lut(enc, cl), dtype=torch.float32,
                          device=words.device)
    proj = lut.T[words].reshape(words.shape[0], -1)                # (n, 4d)
    onehot = torch.nn.functional.one_hot(qw, CELL_STATES).reshape(
        qw.shape[0], -1)
    return (onehot.to(dtype) @ proj.to(dtype).T).to(torch.float32)


def shortlist(qw: torch.Tensor, store: Store, k: int, dtype=torch.float32,
              block_rows: int = 1 << 17,
              visit: tuple[torch.Tensor, int] | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each query's k best rows by (distance, row), never-written rows
    last -> (dist (B, k) float32, rows (B, k) int64). visit: (the shards
    each query visits (B, p), rows a shard), whose rows alone are ranked
    (k <= p rows a shard)."""
    best = None
    n = store.words.shape[0]
    if visit is not None:
        ids, per = visit
        seen = torch.zeros(qw.shape[0], n // per, dtype=torch.bool,
                           device=qw.device).scatter_(1, ids, True)
    for r0 in range(0, n, block_rows):
        d = distances(qw, store.words[r0:r0 + block_rows], store.enc,
                      store.cl, dtype)
        rows = torch.arange(r0, r0 + d.shape[1], device=d.device)
        invalid = (store.labels[r0:r0 + d.shape[1]] < 0).to(torch.int64)
        key = (invalid << 62) | (d.to(torch.int64) << 32) | rows
        if visit is not None:
            key = torch.where(seen[:, rows // per], key, NOT_VISITED)
        cand = key if best is None else torch.cat([best, key], 1)
        best = torch.topk(cand, min(k, cand.shape[1]), dim=1,
                          largest=False, sorted=True).values
    rows = best & U32
    dist = ((best >> 32) & ((1 << 30) - 1)).to(torch.float32)
    dist = dist + MASK_PENALTY * ((best >> 62) & 1).to(torch.float32)
    return dist, rows


def route(qw: torch.Tensor, store: Store, n_shards: int, nprobe: int,
          dtype=torch.float32) -> torch.Tensor:
    """The shards each query visits, (B, nprobe) int64 ascending: the
    nprobe least scores (module docstring), ties to the lower id."""
    sums, counts = store.sketch(n_shards)
    s, r, d = sums.shape
    c = counts.clamp(min=1)[..., None]
    centroids = torch.div(2 * sums + c, 2 * c, rounding_mode="floor").clamp(
        0, levels(store.enc, store.cl) - 1)
    dist = distances(qw, centroids.reshape(s * r, d), store.enc, store.cl,
                     dtype).reshape(-1, s, r)
    scores = (dist + MASK_PENALTY * (counts == 0)).amin(-1)       # (B, S)
    key = scores.to(torch.int64) * s + torch.arange(s, device=qw.device)
    ids = torch.topk(key, nprobe, dim=1, largest=False).indices
    return ids.sort(dim=1).values


# -- phase 2: the noisy string physics --------------------------------------------


def _mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser on int64 tensors holding uint32."""
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """x * m mod 2**32 without leaving int64."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & U32


def _chain(h: torch.Tensor, coord: torch.Tensor, k: int) -> torch.Tensor:
    """The hash state after coordinate number k (from 0)."""
    return _mix(h ^ ((coord + (k + 1) * _GOLDEN) & U32))


def _start(seed: int, device) -> torch.Tensor:
    return torch.tensor((seed * _GOLDEN + _SEED_ADD) & U32,
                        dtype=torch.int64, device=device)


def _normal(h1: torch.Tensor, h2: torch.Tensor, dtype) -> torch.Tensor:
    """Box-Muller over two hash words: sqrt(-2 log u1) cos(2 pi u2), u =
    (h + 0.5) / 2**32."""
    u1 = (h1.to(dtype) + 0.5) * INV_2_32
    u2 = (h2.to(dtype) + 0.5) * INV_2_32
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI * u2)


def physics(qw: torch.Tensor, qidx: torch.Tensor, rows: torch.Tensor,
            store: Store, dtype=torch.float32
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Votes and distances of query words qw (b, d) with noise coordinates
    qidx (b,) against store rows `rows` (b, r) -> (b, r) float32 each."""
    cfg, mc = store.cfg, store.cfg["mcam"]
    sl, enc, cl = mc["string_len"], store.enc, store.cl
    b, d = qw.shape
    seg = math.ceil(d / sl)
    L = code_length(enc, cl)
    S = seg * L
    w = torch.tensor(word_weights(enc, cl), dtype=torch.float32,
                     device=qw.device).repeat(seg)                   # (S,)
    th = torch.as_tensor(thresholds(sl, mc["rho"], mc["n_thresholds"]),
                         device=qw.device).to(dtype)
    pad = seg * sl - d
    qpad = torch.nn.functional.pad(qw, (0, pad)).reshape(b, seg, 1, sl)
    seed = mc["seed"]
    dev = qw.device
    starts = [_chain(_start(s, dev), qidx.to(torch.int64), 0)
              for s in (seed, seed + NORMAL_OFFSET, seed + READ_OFFSET,
                        seed + READ_OFFSET + NORMAL_OFFSET)]
    cell = torch.arange(sl, device=dev)
    log_rho = f32(np.log(mc["rho"]))
    step = max(1, BLOCK_CELLS // (S * sl * b))
    votes, dist = [], []
    for c0 in range(0, rows.shape[1], step):
        r = rows[:, c0:c0 + step]                                    # (b, c)
        v = torch.nn.functional.pad(store.words[r], (0, pad))        # (b,c,dp)
        word = codes(v, enc, cl).reshape(b, r.shape[1], seg, sl, L)
        m = (qpad[:, None] - word.transpose(-1, -2)).abs()           # seg,L,sl
        m = m.reshape(b, r.shape[1], S, sl)
        sid = ((r[..., None] * S + torch.arange(S, device=dev)) & U32)
        h = [_chain(s0[:, None, None], sid, 1) for s0 in starts]
        g1 = _chain(h[0][..., None], cell, 2)
        g2 = _chain(h[1][..., None], cell, 2)
        m_eff = m.to(dtype)
        if cfg["noisy"]:
            m_eff = torch.clamp(m_eff + f32(mc["sigma_device"])
                                * _normal(g1, g2, dtype), 0.0, 3.0)
        e = torch.exp(m_eff * log_rho)
        res = e[..., 0]
        for j in range(1, sl):
            res = res + e[..., j]
        cur = torch.full_like(res, float(sl)) / res
        if cfg["noisy"]:
            cur = cur * (1.0 + f32(mc["sigma_read"])
                         * _normal(h[2], h[3], dtype))
        count = (cur[..., None] > th).sum(-1).to(dtype)
        votes.append((count * w.to(dtype)).sum(-1).to(torch.float32))
        dist.append((m.sum(-1).to(dtype) * w.to(dtype)).sum(-1).to(
            torch.float32))
    return torch.cat(votes, 1), torch.cat(dist, 1)


def predict(votes: torch.Tensor, dist: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """The label of each query's best candidate: most votes, ties by the
    smaller distance, then by the earlier position."""
    top = votes.max(-1, keepdim=True).values
    tied = torch.where(votes == top, dist, torch.full_like(dist, math.inf))
    return labels.gather(1, tied.argmin(-1, keepdim=True))[:, 0]


# -- the searches -----------------------------------------------------------------


def two_phase(q: torch.Tensor, store: Store, k: int, dtype=torch.float32,
              route_by: tuple[int, int] | None = None
              ) -> dict[str, torch.Tensor]:
    """Shortlist then noisy rescore of float queries q (B, d); route_by:
    (n_shards, nprobe) of a routed search, which visits every row where
    nprobe >= n_shards ("shards": the visited shards)."""
    qw = store.query_words(q)
    out = {}
    visit = None
    if route_by is not None and route_by[1] < route_by[0]:
        n_shards, nprobe = route_by
        per = store.words.shape[0] // n_shards
        out["shards"] = route(qw, store, n_shards, nprobe, dtype)
        visit, k = (out["shards"], per), min(k, nprobe * per)
    dist, rows = shortlist(qw, store, k, dtype, visit=visit)
    votes, _ = physics(qw, torch.arange(qw.shape[0], device=q.device), rows,
                       store, dtype)
    labels = store.labels[rows]
    votes = torch.where(labels >= 0, votes, -math.inf)
    return out | {"words": qw, "rows": rows, "dist": dist, "votes": votes,
                  "labels": labels, "pred": predict(votes, dist, labels)}


def full(q: torch.Tensor, store: Store, qidx: torch.Tensor,
         dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Noisy search of every row for float queries q (b, d) whose noise
    coordinates (their positions in the served batch) are qidx (b,)."""
    qw = store.query_words(q)
    n = store.words.shape[0]
    rows = torch.arange(n, device=q.device).expand(qw.shape[0], n)
    votes, dist = physics(qw, qidx, rows, store, dtype)
    labels = store.labels.expand(qw.shape[0], n)
    votes = torch.where(labels >= 0, votes, -math.inf)
    return {"words": qw, "rows": rows, "dist": dist, "votes": votes,
            "labels": labels, "pred": predict(votes, dist, labels)}
