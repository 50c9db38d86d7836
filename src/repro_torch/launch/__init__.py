"""Launchers (port of `repro.launch`): the LM trainer, the
hardware-aware trainer and the serving launcher (LM decode with the
kNN-LM head, multi-tenant search)."""
