"""Procedural few-shot data and the LM token pipeline (copies of
`repro.data`, numpy only)."""
