"""Procedural few-shot data (a copy of `repro.data`, numpy only)."""
