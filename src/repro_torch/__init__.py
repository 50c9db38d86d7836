"""PyTorch / CUDA port of the AVSS / MCAM retrieval system.

The JAX package (`repro`) is the reference; this package mirrors its module
names (`core`, `kernels`, `engine`) and is held against it by the
`tests/test_torch_*.py` parity tests. It imports `torch` and numpy only.

Entry points (`engine.MemoryStore` constructors) place the store on the
CUDA device unless the caller passes `device="cpu"`. Every kernel wrapper
dispatches on the device of the tensors it is given: a CPU tensor runs the
kernel's plain PyTorch version, a CUDA tensor launches the hand-written
sm_90a kernel from `csrc/` (built with nvcc at first use) or raises.
"""
