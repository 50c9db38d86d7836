"""Analytic latency / energy model of the MCAM search (paper Table 2 /
Fig. 9; port of `repro.core.costmodel`).

Iteration counts are exact (Sec. 3.2). Absolute rates and energies are
anchored to the paper's Table 2 throughput numbers, which back-solve to a
block search rate of 20k word-line cycles/s on the measured device of
Tseng et al. [14]:

    Omniglot  SVSS 64 it -> 312.5 /s      AVSS 2 it -> 10000 /s   (32x)
    CUB       SVSS 500 it -> 40 /s        AVSS 20 it -> 1000 /s   (25x)

Energy is in normalised units of one string search (one string, one
word-line cycle); a whole-block cycle costs `n_strings` units. These are
figures of the simulated flash device, not of the GPU that runs the
simulation.
"""

from __future__ import annotations

import math

from repro_torch.core import avss as avss_lib
from repro_torch.core.encodings import Encoding
from repro_torch.core.mcam import DEFAULT_STRING_LEN

BLOCK_SEARCH_RATE_HZ = 20_000.0  # word-line cycles per second (Table 2)
E_STRING_SEARCH = 1.0            # normalised energy unit


def iterations(d: int, enc: Encoding, mode: str,
               string_len: int = DEFAULT_STRING_LEN) -> int:
    return avss_lib.search_iterations(d, enc, mode, string_len)


def throughput_searches_per_s(d: int, enc: Encoding, mode: str,
                              string_len: int = DEFAULT_STRING_LEN) -> float:
    return BLOCK_SEARCH_RATE_HZ / iterations(d, enc, mode, string_len)


def strings_used(d: int, enc: Encoding, n_supports: int,
                 string_len: int = DEFAULT_STRING_LEN) -> int:
    return avss_lib.strings_per_support(d, enc, string_len) * n_supports


def energy_per_query(d: int, enc: Encoding, mode: str, n_supports: int,
                     string_len: int = DEFAULT_STRING_LEN) -> float:
    """Energy of one query: every active string is sensed once per
    word-line cycle in which it participates, in AVSS (the L strings of a
    segment share a cycle) as in SVSS (each string in its own cycle), so
    E = strings_used; the encodings differ through strings_used, which
    gives Fig. 9's ordering: longer codes cost more energy."""
    del mode
    return E_STRING_SEARCH * strings_used(d, enc, n_supports, string_len)


def blocks_required(d: int, enc: Encoding, n_supports: int,
                    string_len: int = DEFAULT_STRING_LEN,
                    block_strings: int = 131072) -> int:
    return math.ceil(strings_used(d, enc, n_supports, string_len)
                     / block_strings)
