"""What decides `correct`: the program's outputs in the window, held
against the plain reference (bench/reference/mcam.py) computed again from
the same inputs after the window has closed.

The reference is given the float supports, the writes in their order and
the queries of the checked batches, and works out the rest itself. It
replays the ring write by write, so each checked batch meets the store as
the program's search met it. Each number below counts disagreements; the
cell's file gives each its limit.

  query_words_wrong  query words (the store's quantize_queries) that differ
  rows_wrong         candidate rows that differ: phase 1's shortlist in
                     order of (distance, row); `full`: every row
  dist_wrong         candidates' ideal distances that differ
  votes_wrong        candidates' noisy votes that differ
  labels_wrong       candidates' labels that differ
  predictions_wrong  labels the window delivered to the host that differ
  store_wrong        the final store's quantised words, labels, write count
                     and calibrated range that differ
"""

from __future__ import annotations

import numpy as np
import torch

from bench.reference import mcam

NUMBERS = ("query_words_wrong", "rows_wrong", "dist_wrong", "votes_wrong",
           "labels_wrong", "predictions_wrong", "store_wrong")


def _diff(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(b.device, b.dtype) != b).sum())


def compare(config: dict, traffic: dict, supports, writes, sampled: dict,
            store, device) -> dict:
    """The numbers of the module docstring for one run.

    supports: (x, labels) of the initial store; writes: every later write
    (x, labels), in order; sampled: {batch no: (the batch's queries and
    results by name, delivered labels, writes before it)}; store: the
    program's store after the window."""
    out = dict.fromkeys(NUMBERS, 0)
    ref = mcam.Store(config, device)
    ref.calibrate(supports[0])
    ref.write(*supports)
    applied = 0
    for no in sorted(sampled):
        got, delivered, n_writes = sampled[no]
        q = got["queries"]
        while applied < n_writes:
            ref.write(*writes[applied])
            applied += 1
        with torch.no_grad():
            if traffic["mode"] == "two_phase":
                r = mcam.two_phase(q, ref, traffic["k"])
            else:
                r = mcam.full(q, ref, torch.arange(q.shape[0],
                                                   device=q.device))
        out["query_words_wrong"] += _diff(store.quantize_queries(q),
                                          r["words"])
        for name, have, want in (("rows_wrong", "indices", "rows"),
                                 ("dist_wrong", "dist", "dist"),
                                 ("votes_wrong", "votes", "votes"),
                                 ("labels_wrong", "labels", "labels")):
            out[name] += _diff(got[have], r[want])
        out["predictions_wrong"] += int(np.sum(
            np.asarray(delivered) != r["pred"].cpu().numpy()))
    while applied < len(writes):
        ref.write(*writes[applied])
        applied += 1
    out["store_wrong"] = (
        _diff(store.values, ref.words) + _diff(store.labels, ref.labels)
        + int(int(store.size) != ref.size)
        + int(not torch.equal(store.lo.cpu().float(), ref.lo.cpu()))
        + int(not torch.equal(store.hi.cpu().float(), ref.hi.cpu())))
    return out
