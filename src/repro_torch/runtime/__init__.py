"""Training runtime (port of `repro.runtime` on one device): the int8
gradient codec with error feedback, and fault tolerance (anomaly skips,
preemption, the step watchdog)."""
