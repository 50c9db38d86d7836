"""Behavioural model of the 3D-NAND multi-bit CAM (PyTorch port of
`repro.core.mcam`).

A string of `string_len` cells is a series connection: cell resistance
R(m) = rho**m for mismatch level m, string current I = string_len / sum R.
Device variation perturbs the mismatch exponent (sigma_device), the sense
path adds multiplicative read noise (sigma_read), and a sense amplifier
counts the reference currents the string current exceeds.

Noise is a counter-based hash of absolute (query, string, cell)
coordinates. PyTorch's CPU uint32 arithmetic is incomplete, so the hash
runs on int64 tensors holding uint32 values, masked to 32 bits after every
multiply and add; the CUDA kernels compute the same bits in native uint32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.encodings import MAX_MISMATCH

DEFAULT_STRING_LEN = 24
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class MCAMConfig:
    """Hardware parameters of the simulated MCAM block."""

    string_len: int = DEFAULT_STRING_LEN
    rho: float = 8.0            # per-mismatch-level series resistance ratio
    sigma_device: float = 0.12  # stddev of per-cell mismatch-exponent noise
    sigma_read: float = 0.04    # stddev of multiplicative current read noise
    n_thresholds: int = 8       # SA reference levels
    max_strings: int = 131072   # 128K strings per block
    seed: int = 0

    def thresholds(self) -> np.ndarray:
        """SA reference currents (ascending float32): ideal currents of
        strings with s uniformly-spread single-level mismatches, s
        geometrically spaced."""
        smax = 1.5 * self.string_len
        s = np.unique(np.round(np.geomspace(1.0, smax, self.n_thresholds)))
        while len(s) < self.n_thresholds:
            extra = s[-1:] + np.arange(1, 1 + self.n_thresholds - len(s))
            s = np.unique(np.concatenate([s, extra]))
        s = s[: self.n_thresholds].astype(np.float64)
        i_ideal = self.string_len / ((self.string_len - s) + s * self.rho)
        return np.sort(i_ideal).astype(np.float32)


def f32(x: float) -> float:
    """`x` rounded to the nearest float32, as a Python float: a scalar
    operand that torch's float32 kernels use without a second rounding."""
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# Counter-based deterministic noise.
# ---------------------------------------------------------------------------

_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_GOLDEN = 0x9E3779B9
_SEED_ADD = 0x85EBCA6B
#: seed offset of the second uniform stream of `hash_normal`
NORMAL_SEED_OFFSET = 0x5BD1
_INV_2_32 = f32(1.0 / 4294967296.0)
_TWO_PI = f32(2.0 * np.float32(np.pi))


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2**32 for int64 x in [0, 2**32): split into 16-bit halves
    of m so no intermediate leaves the int64 range."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3-style 32-bit finalizer on int64 tensors holding uint32."""
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    x = x ^ (x >> 16)
    return x


def _as_u32(i, device=None) -> torch.Tensor:
    """Integer coordinate(s) -> int64 tensor of their uint32 values (the
    wraparound `astype(uint32)` gives)."""
    return torch.as_tensor(i, device=device).to(torch.int64) & _U32


def hash_bits(*idx, seed: int) -> torch.Tensor:
    """The uint32 hash of integer coordinates (broadcasting), as int64."""
    device = next((i.device for i in idx if isinstance(i, torch.Tensor)),
                  None)
    h = torch.tensor((seed * _GOLDEN + _SEED_ADD) & _U32, dtype=torch.int64,
                     device=device)
    for k, i in enumerate(idx):
        step = ((k + 1) * _GOLDEN) & _U32
        h = _mix(h ^ ((_as_u32(i, device) + step) & _U32))
    return h


def hash_uniform(*idx, seed: int) -> torch.Tensor:
    """Deterministic uniform(0, 1) float32 from integer coordinates. The
    int64 -> float32 conversion rounds to nearest even, as XLA's uint32 ->
    float32 conversion and CUDA's `__uint2float_rn` do."""
    h = hash_bits(*idx, seed=seed)
    return (h.to(torch.float32) + 0.5) * _INV_2_32


def hash_normal(*idx, seed: int) -> torch.Tensor:
    """Deterministic standard normal via Box-Muller over two hash streams:
    sqrt(-2 log u1) * cos((2 * f32(pi)) * u2)."""
    u1 = hash_uniform(*idx, seed=seed)
    u2 = hash_uniform(*idx, seed=seed + NORMAL_SEED_OFFSET)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(_TWO_PI * u2)


# ---------------------------------------------------------------------------
# String current + sense amplifier.
# ---------------------------------------------------------------------------


def string_resistance(cell_mismatch: torch.Tensor, cfg: MCAMConfig,
                      device_noise: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Sum of per-cell series resistances rho**m; reduces the trailing
    axis."""
    m = cell_mismatch.to(torch.float32)
    if device_noise is not None:
        m = m + f32(cfg.sigma_device) * device_noise
        m = torch.clamp(m, 0.0, float(MAX_MISMATCH))
    rho = torch.tensor(cfg.rho, dtype=torch.float32, device=m.device)
    return torch.pow(rho, m).sum(-1)


def current_from_resistance(r_sum: torch.Tensor, n_cells: int,
                            cfg: MCAMConfig,
                            read_noise: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """I = n_cells / sum_R, normalised so a perfect match reads 1.0."""
    i = float(n_cells) / r_sum
    if read_noise is not None:
        i = i * (1.0 + f32(cfg.sigma_read) * read_noise)
    return i


def string_current(cell_mismatch: torch.Tensor, cfg: MCAMConfig, *,
                   noise_idx: tuple | None = None) -> torch.Tensor:
    """Full noisy current for strings of cells; reduces the trailing axis.

    noise_idx: integer coordinate tensors broadcastable to
    cell_mismatch.shape[:-1]; when given, deterministic device/read noise
    is derived from them (plus the cell index for device noise)."""
    n_cells = cell_mismatch.shape[-1]
    if noise_idx is None:
        return current_from_resistance(string_resistance(cell_mismatch, cfg),
                                       n_cells, cfg)
    cell = torch.arange(n_cells, device=cell_mismatch.device)
    bidx = tuple(_as_u32(i, cell_mismatch.device)[..., None]
                 for i in noise_idx)
    dn = hash_normal(*bidx, cell, seed=cfg.seed)
    rn = hash_normal(*(_as_u32(i, cell_mismatch.device) for i in noise_idx),
                     seed=cfg.seed + 0x2C1B)
    r = string_resistance(cell_mismatch, cfg, device_noise=dn)
    return current_from_resistance(r, n_cells, cfg, read_noise=rn)


def sa_votes(currents: torch.Tensor, cfg: MCAMConfig,
             thresholds: torch.Tensor | None = None) -> torch.Tensor:
    """Sense-amplifier voting: count of reference levels the current
    exceeds, as float32."""
    th = torch.as_tensor(cfg.thresholds() if thresholds is None
                         else thresholds, device=currents.device)
    return (currents[..., None] > th).sum(-1).to(torch.float32)


def ideal_current(total_mismatch: torch.Tensor, cfg: MCAMConfig
                  ) -> torch.Tensor:
    """Noise-free current of a string whose mismatch is spread one level
    per cell (the best case for a given total)."""
    s = total_mismatch.to(torch.float32)
    n = float(cfg.string_len)
    return n / ((n - s) + s * f32(cfg.rho))
