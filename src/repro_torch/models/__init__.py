"""Feature-extraction controllers (port of `repro.models`)."""
