"""Models (port of `repro.models`): the few-shot feature-extraction
controllers and the decoder-only language model (layers, MoE,
transformer)."""
