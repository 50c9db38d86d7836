"""Launchers (port of `repro.launch`): the hardware-aware trainer."""
