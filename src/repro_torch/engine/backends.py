"""Backend names of the retrieval engine (port of
`repro.engine.backends`). The names are the JAX package's, so one
`SearchRequest` means the same in both packages; in this port they name
the hand-written CUDA kernels:

  ref     plain PyTorch reference (kernels/ref.py); launches no kernel.
  pallas  full search: csrc/mcam_search.cu (dense); two_phase phase 1
          below fused_min_rows: the LUT product csrc/mcam_dist.cu, then a
          stable selection; at or above it: csrc/shortlist.cu.
  mxu     the same as `pallas`.
  fused   shortlists always through csrc/shortlist.cu; full as `pallas`.

Every backend gives the same results (integer-exact distances, the same
counter-hash noise). On a CPU store each kernel wrapper runs its plain
version, so the backend still selects the same route.

No counterpart: the reference's `KERNEL_BACKENDS`, which nothing reads.
"""

from __future__ import annotations

BACKENDS = ("ref", "pallas", "mxu", "fused")


def kernels_available() -> bool:
    """True when the kernel package (`repro_torch.kernels.ops`) imports,
    as the reference's says of its Pallas package. It does not look for
    a GPU (the wrappers build and launch their kernels on a CUDA tensor
    at first use) and switches nothing."""
    try:
        from repro_torch.kernels import ops  # noqa: F401
        return True
    except ImportError:
        return False


def resolve_backend(backend: str = "auto", use_kernel: str = "auto") -> str:
    """Resolve an engine-level override plus a SearchConfig preference:
    `backend` wins over `use_kernel`; 'auto' defers, and resolves to
    'pallas' (the kernels are part of this package)."""
    for choice in (backend, use_kernel):
        if choice != "auto":
            if choice not in BACKENDS:
                raise ValueError(
                    f"unknown backend {choice!r}; expected one of "
                    f"{BACKENDS + ('auto',)}")
            return choice
    return "pallas"
