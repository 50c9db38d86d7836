"""Static-analysis contract guard of the port (counterpart of
`repro.analysis`): contracts, AST lint, resources.

Passes, one CLI (`python -m repro_torch.analysis`):

  run        build every registered (invariant x entry-point x config)
             cell, trace its call and check the record
             (analysis/registry.py, contracts.py); writes
             results/contract_report.json.
  lint       repo-specific AST rules over src/repro_torch
             (analysis/lint.py).
  diff       compare two contract reports; new failures exit non-zero.
  cost       the resource oracle (analysis/cost.py): one {flops,
             hbm_bytes_read/written, temp_bytes, peak_bytes, launches,
             host_syncs} row per registry route, from one trace of the
             route; writes results/resource_report.json.
  cost-diff  compare two resource reports against a relative tolerance;
             drift or a lost route exits non-zero.

analysis/vmem.py is the shared-memory side of the oracle: the closed-form
budget of the shortlist kernel's select blocks, which
`launch/time_blocks.py --variants` uses to reject an over-budget plan
before timing it.

Where the reference compiles, the port traces (analysis/cost.py says
how); the reference forces 8 host devices, the port's sharded cells use
8 positions of one device. Nothing runs when this package is imported.
"""
