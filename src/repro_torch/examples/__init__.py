"""Runnable examples of the port, twins of the JAX package's
`examples/quickstart.py`, `examples/fsl_omniglot.py`,
`examples/serve_retrieval.py` and `examples/train_llm.py`:

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.fsl_omniglot [--device cpu] [...]
    python -m repro_torch.examples.serve_retrieval [--device cpu] [...]
    python -m repro_torch.examples.train_llm [--device cpu] [...]

Importing a module here runs nothing.
"""
