"""Runnable examples of the port, twins of the JAX package's
`examples/quickstart.py` and `examples/fsl_omniglot.py`:

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.fsl_omniglot [--device cpu] [...]

Importing a module here runs nothing.
"""
