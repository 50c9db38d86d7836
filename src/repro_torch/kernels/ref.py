"""Plain-torch oracle for the MCAM search kernels (port of
`repro.kernels.ref`).

Semantics contract, per query b, support n, string s of S, cell of sl:

    m         = |q - s| per cell                               (f32)
    string_id = n * S + s
    dev       = hash_normal(b, string_id, cell; seed)
    m_eff     = clip(m + sigma_device * dev, 0, 3)
    R         = sum_cell exp(m_eff * f32(log rho))
    I         = sl / R * (1 + sigma_read * hash_normal(b, string_id; seed+RD))
    votes    += weights[s] * #(I > thresholds)
    dist     += weights[s] * sum_cell m

No counterpart, by design: `mcam_search_ref`'s `query_chunk`, the batch
size of the reference's `lax.map` over queries; here the plain version
loops over queries one at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import mcam as mcam_lib
from repro_torch.core.encodings import MAX_MISMATCH
from repro_torch.core.mcam import MCAMConfig, f32

READ_SEED_OFFSET = 0x2C1B


def mcam_search_ref(q_strings: torch.Tensor, s_strings: torch.Tensor,
                    weights: torch.Tensor, thresholds: torch.Tensor,
                    cfg: MCAMConfig, *, noisy: bool = True
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B, S, sl) int8, s (N, S, sl) int8 -> votes (B, N), dist (B, N),
    one query at a time (the query coordinate is the batch position)."""
    B, S, sl = q_strings.shape
    N = s_strings.shape[0]
    dev_ = s_strings.device
    string_id = (torch.arange(N, dtype=torch.int64, device=dev_)[:, None] * S
                 + torch.arange(S, dtype=torch.int64, device=dev_)[None, :])
    string_id = string_id & 0xFFFFFFFF
    cell = torch.arange(sl, dtype=torch.int64, device=dev_)
    log_rho = f32(np.log(cfg.rho))
    th = thresholds.to(dev_)
    w = weights.to(dev_)[None, :]
    votes, dist = [], []
    for b in range(B):
        m = torch.abs(q_strings[b][None].to(torch.int32)
                      - s_strings.to(torch.int32)).to(torch.float32)
        if noisy:
            dn = mcam_lib.hash_normal(b, string_id[..., None],
                                      cell[None, None, :], seed=cfg.seed)
            m_eff = torch.clamp(m + f32(cfg.sigma_device) * dn, 0.0,
                                float(MAX_MISMATCH))
        else:
            m_eff = m
        r = torch.exp(m_eff * log_rho).sum(-1)                  # (N, S)
        cur = torch.div(torch.tensor(float(sl)), r)
        if noisy:
            rd = mcam_lib.hash_normal(b, string_id,
                                      seed=cfg.seed + READ_SEED_OFFSET)
            cur = cur * (1.0 + f32(cfg.sigma_read) * rd)
        v = (cur[..., None] > th).sum(-1).to(torch.float32)
        votes.append((v * w).sum(-1))
        dist.append((m.sum(-1) * w).sum(-1))
    return torch.stack(votes), torch.stack(dist)


def avss_dist_ref(q_values: torch.Tensor, s_values: torch.Tensor,
                  sum_lut: torch.Tensor) -> torch.Tensor:
    """Ideal (noise-free) AVSS digital distance through the (4, levels)
    LUT: dist[b, n] = sum_d LUT[q[b, d], v[n, d]], summed over d in order
    (exact: integer values below 2**24)."""
    lut = sum_lut.to(s_values.device, torch.float32)
    q = q_values.to(torch.int64)
    v = s_values.to(torch.int64)
    dist = torch.zeros(q.shape[0], v.shape[0], dtype=torch.float32,
                       device=v.device)
    for d in range(q.shape[1]):
        dist += lut[:, v[:, d]][q[:, d]]
    return dist
