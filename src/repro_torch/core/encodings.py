"""Encoding schemes for MCAM vector similarity search (PyTorch port of
`repro.core.encodings`).

  * MTMC  -- 4-ary thermometer code (paper Sec. 3.1, Table 1).
  * B4E   -- base-4 bit slicing.
  * B4WE  -- base-4 weighted encoding: B4E word of significance j repeated
             4^j times, MSB repeated most.
  * SRE   -- simple repetition encoding: the 4-level value repeated r times.

Every code word is an integer in [0, 3] (one MLC unit cell = 4 states).
`encode_words_ste` is the straight-through encoder of hardware-aware
training: its forward is `Encoding.encode`, bit for bit.
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

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """(..., length) code words -> (...,) values; the inverse of
        `encode`. The result's dtype is the reference's: MTMC and B4E sum,
        which widens integer codes narrower than int32 to int32 (JAX's
        default integer); SRE and B4WE keep the codes' dtype. Rounding is
        half to even in both packages."""
        codes = torch.as_tensor(codes)
        if self.name == "mtmc":
            return codes.sum(-1, dtype=_sum_dtype(codes.dtype))
        if self.name == "sre":
            # all words equal; the rounded mean is robust to perturbation
            return torch.round(codes.to(torch.float32).mean(-1)).to(
                codes.dtype)
        if self.name == "b4e":
            w = torch.tensor(self.weights, device=codes.device).to(
                codes.dtype)
            return (codes * w).sum(-1, dtype=_sum_dtype(codes.dtype))
        # b4we: significance j appears 4**j times, MSB group first: each
        # digit is its group's rounded mean
        vals = torch.zeros(codes.shape[:-1], dtype=codes.dtype,
                           device=codes.device)
        idx = 0
        for j in reversed(range(self.cl)):
            rep = CELL_STATES**j
            digit = torch.round(
                codes[..., idx:idx + rep].to(torch.float32).mean(-1))
            vals = vals + digit.to(codes.dtype) * (CELL_STATES**j)
            idx += rep
        return vals

    def weights_array(self, dtype=torch.float32,
                      device: torch.device | str | None = None
                      ) -> torch.Tensor:
        return torch.tensor(self.weights, dtype=dtype, device=device)


def _sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of a sum over `dtype` as JAX gives it (64-bit types off):
    integers narrower than 32 bits widen to int32, others keep theirs."""
    if dtype.is_floating_point or dtype in (torch.int32, torch.int64):
        return dtype
    return torch.int32


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


# ---------------------------------------------------------------------------
# Differentiable (straight-through) encoders for hardware-aware training.
# The forward values are the hard encoders' above, bit for bit on
# integer-valued inputs; only the gradient differs.
# ---------------------------------------------------------------------------


def _f32(x: float, device: torch.device) -> torch.Tensor:
    """A 0-dim float32 divisor on the dividend's device: CUDA multiplies
    by the reciprocal of a CPU scalar divisor, which rounds twice where
    JAX's division rounds once (ROADMAP C.P7). It is filled on the
    device: a tensor copied from the host would wait for the stream."""
    return torch.full((), float(x), dtype=torch.float32, device=device)


class _MtmcWordSte(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, c, cl):
        ctx.cl = cl
        x = torch.floor(torch.div(v, _f32(cl, v.device)))
        n = v - x * cl
        return torch.clamp(x + (c >= cl - n).to(v.dtype), 0, MAX_MISMATCH)

    @staticmethod
    def backward(ctx, g):
        return torch.div(g, _f32(ctx.cl, g.device)), None, None


def mtmc_word_ste(v: torch.Tensor, c: int, cl: int) -> torch.Tensor:
    """c-th MTMC code word of the integer-valued float v; gradient 1/CL
    (the discrete encoder's trend line). Forward equals column c of the
    hard MTMC encoder."""
    return _MtmcWordSte.apply(v, c, cl)


def encode_words_ste(v: torch.Tensor, enc: Encoding) -> torch.Tensor:
    """(...,) integer-valued float values -> (..., length) code words with
    straight-through gradients: forward `enc.encode(v)`, gradient 1/CL per
    word for MTMC and 1/length to each word otherwise."""
    if enc.name == "mtmc":
        return torch.stack([mtmc_word_ste(v, c, enc.cl)
                            for c in range(enc.cl)], dim=-1)
    hard = enc.encode(v.to(torch.int32)).to(torch.float32)
    vv = v[..., None]
    return hard + torch.div(vv - vv.detach(), _f32(enc.length, v.device))


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


def svss_pair_mismatch(enc: Encoding, a: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """Per-word |code(a) - code(b)| for symmetric search: (..., length), in
    the values' dtype."""
    return torch.abs(enc.encode(a) - enc.encode(b))
