"""The work of each kernel the cells drive, counted from the cell's shapes
alone, and the H100's peaks: the yardstick of the roofline shares. A
family (bench/families/) says which of these one batch of its cell
drives, at which shapes.

The formulas are fixed here, whatever implements the work:

  shortlist  b queries, each ranking `visit` rows of d dimensions (every
             row, or the rows of the shards it visits), top k: the
             one-hot LUT product, 2 b visit 4d operations at the int8
             tensor-core rate; bytes: each of the n distinct rows read,
             its 4d LUT entries packed at 8 bits (4d bytes) and one mask
             byte, the query words (4 bytes each) and the (b, k) output
             of 12 bytes an entry
  rescore    b queries x k candidates of s strings of sl cells:
             PHYSICS_OPS_PER_CELL a cell at the float32 rate; bytes: each
             candidate's cells (one byte each), the query's cells, the
             candidate's row and noise row and the output
  dense      b queries x n rows of s strings of sl cells: the same a cell;
             bytes: every row's cells, the queries' cells, votes and dist

A bound is the larger of bytes over HBM_BYTES_PER_S and operations over
the rate; `bound_by` names which.
"""

from __future__ import annotations

import math

#: NVIDIA's data sheet, H100 SXM (dense), at the full 700 W power limit
CARD = "NVIDIA H100 80GB HBM3"
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT8_TENSOR_OPS_PER_S = 1979e12

# Scalar operations of one noisy cell, counted by hand from the cell
# formula: two hash streams (2 x 10), two uniforms (2 x 3), Box-Muller
# (6), the mismatch (2), noise and clip (4), exp and the sum (3), the
# distance sum (1) and the string's share of its per-string terms (3).
PHYSICS_OPS_PER_CELL = 2 * 10 + 2 * 3 + 6 + 2 + 4 + 3 + 1 + 3


def _bound(ops: float, nbytes: float, rate: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return {"ops": ops, "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def shortlist(b: int, n: int, d: int, k: int, visit: int | None = None
              ) -> dict:
    visit = n if visit is None else visit
    nbytes = n * 4 * d + n + b * d * 4 + b * k * 12
    return _bound(2 * b * visit * 4 * d, nbytes, INT8_TENSOR_OPS_PER_S)


def rescore(b: int, k: int, s: int, sl: int) -> dict:
    nbytes = b * k * s * sl + b * s * sl + b * k * 16 + b * k * 4 + s * 4
    return _bound(b * k * s * sl * PHYSICS_OPS_PER_CELL, nbytes,
                  F32_OPS_PER_S)


def dense(b: int, n: int, s: int, sl: int) -> dict:
    nbytes = n * s * sl + b * s * sl + b * n * 8 + s * 4
    return _bound(b * n * s * sl * PHYSICS_OPS_PER_CELL, nbytes,
                  F32_OPS_PER_S)


def strings(config: dict) -> int:
    """Strings a support occupies: segments of `string_len` dimensions
    times the code words a dimension."""
    sl = config["mcam"]["string_len"]
    words = config["cl"]
    if config["encoding"] == "b4we":
        words = (4 ** config["cl"] - 1) // 3
    return math.ceil(config["dim"] / sl) * words

