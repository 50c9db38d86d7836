"""Launchers (port of `repro.launch`): the hardware-aware trainer and the
serving launcher (LM decode with the kNN-LM head, multi-tenant search)."""
