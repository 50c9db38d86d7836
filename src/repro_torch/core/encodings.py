"""Encoding schemes for MCAM vector similarity search (PyTorch port of
`repro.core.encodings`).

  * MTMC  -- 4-ary thermometer code (paper Sec. 3.1, Table 1).
  * B4E   -- base-4 bit slicing.
  * B4WE  -- base-4 weighted encoding: B4E word of significance j repeated
             4^j times, MSB repeated most.
  * SRE   -- simple repetition encoding: the 4-level value repeated r times.

Every code word is an integer in [0, 3] (one MLC unit cell = 4 states).
The straight-through encoders used by hardware-aware training are not part
of this module yet (ROADMAP Queue A5).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

CELL_STATES = 4  # MLC flash: 4 programmable states per unit cell.
MAX_MISMATCH = CELL_STATES - 1


@dataclasses.dataclass(frozen=True)
class Encoding:
    """A value -> code-word mapping for MCAM storage.

    name: scheme identifier; cl: the scheme's code-word-length parameter;
    length: unit cells per dimension after encoding; levels: representable
    quantization levels; weights: (length,) per-word accumulation weights
    (Eq. 2 of the paper).
    """

    name: str
    cl: int
    length: int
    levels: int
    weights: tuple

    def encode(self, values: torch.Tensor) -> torch.Tensor:
        """(...,) ints in [0, levels) -> (..., length) code words in [0, 3],
        in the dtype of `values`."""
        return _ENCODERS[self.name](torch.as_tensor(values), self.cl)

    def weights_array(self, dtype=torch.float32,
                      device: torch.device | str | None = None
                      ) -> torch.Tensor:
        return torch.tensor(self.weights, dtype=dtype, device=device)


def _mtmc_encode(values: torch.Tensor, cl: int) -> torch.Tensor:
    """value m -> first cl-n words = x, last n words = x+1 with
    x = m // cl, n = m mod cl. Range [0, 3*cl]."""
    x = torch.div(values, cl, rounding_mode="floor")
    n = torch.remainder(values, cl)
    w = torch.arange(cl, dtype=values.dtype, device=values.device)
    codes = x[..., None] + (w >= (cl - n)[..., None]).to(values.dtype)
    return torch.clamp(codes, 0, MAX_MISMATCH)


def _b4e_encode(values: torch.Tensor, cl: int) -> torch.Tensor:
    """Base-4 encoding, MSB first (value 7, cl=2 -> [1, 3])."""
    shifts = torch.tensor([CELL_STATES ** (cl - 1 - i) for i in range(cl)],
                          dtype=values.dtype, device=values.device)
    return torch.remainder(
        torch.div(values[..., None], shifts, rounding_mode="floor"),
        CELL_STATES)


def _sre_encode(values: torch.Tensor, r: int) -> torch.Tensor:
    """Simple repetition: 4-level value repeated r times."""
    return values[..., None].expand(*values.shape, r).clone()


def _b4we_encode(values: torch.Tensor, cl: int) -> torch.Tensor:
    """B4E word of significance j repeated 4^j times, MSB group first."""
    b4e = _b4e_encode(values, cl)
    parts = [b4e[..., i:i + 1].expand(*values.shape, CELL_STATES ** (cl - 1 - i))
             for i in range(cl)]
    return torch.cat(parts, dim=-1)


_ENCODERS = {
    "mtmc": _mtmc_encode,
    "b4e": _b4e_encode,
    "sre": _sre_encode,
    "b4we": _b4we_encode,
}


def make_encoding(name: str, cl: int) -> Encoding:
    """Factory. `cl` is the code-word-length parameter from the paper:
    word count for mtmc/b4e, repeat count for sre, base word count for b4we.
    """
    name = name.lower()
    if name == "mtmc":
        return Encoding(name, cl, cl, 3 * cl + 1, tuple([1.0] * cl))
    if name == "b4e":
        w = tuple(float(CELL_STATES ** (cl - 1 - i)) for i in range(cl))
        return Encoding(name, cl, cl, CELL_STATES**cl, w)
    if name == "sre":
        return Encoding(name, cl, cl, CELL_STATES, tuple([1.0] * cl))
    if name == "b4we":
        length = (CELL_STATES**cl - 1) // 3
        w = []
        for i in range(cl):
            w.extend([1.0] * (CELL_STATES ** (cl - 1 - i)))
        return Encoding(name, cl, length, CELL_STATES**cl, tuple(w))
    raise ValueError(f"unknown encoding {name!r}")


# ---------------------------------------------------------------------------
# AVSS lookup tables (host-side numpy constants of the encoding):
#   LUT_wrd[c][q, v] = |q - code_c(v)|,  LUT_sum[q, v] = sum_c w_c LUT_wrd[c].
# ---------------------------------------------------------------------------


def avss_word_luts(enc: Encoding) -> np.ndarray:
    """(length, 4, levels) int32 table: |q - code_c(v)| per word c."""
    codes = enc.encode(torch.arange(enc.levels, dtype=torch.int64)).numpy()
    q = np.arange(CELL_STATES)[:, None]
    return np.abs(q[None] - codes.T[:, None, :]).astype(np.int32)


def avss_sum_lut(enc: Encoding) -> np.ndarray:
    """(4, levels) float32: weighted summed mismatch per (query word, value)."""
    luts = avss_word_luts(enc).astype(np.float64)
    w = np.asarray(enc.weights, dtype=np.float64)[:, None, None]
    return (luts * w).sum(0).astype(np.float32)


def avss_max_lut(enc: Encoding) -> np.ndarray:
    """(4, levels) int32: max per-word mismatch per (query word, value)."""
    return avss_word_luts(enc).max(0).astype(np.int32)
