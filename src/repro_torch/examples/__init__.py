"""Runnable examples of the port, twins of the JAX package's
`examples/quickstart.py`, `examples/fsl_omniglot.py` and
`examples/serve_retrieval.py`:

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.fsl_omniglot [--device cpu] [...]
    python -m repro_torch.examples.serve_retrieval [--device cpu] [...]

Importing a module here runs nothing.
"""
