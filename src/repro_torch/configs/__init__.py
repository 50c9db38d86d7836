"""Experiment configurations (port of `repro.configs`)."""
