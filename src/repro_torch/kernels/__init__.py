"""Kernel layer: hand-written CUDA kernels (`csrc/`), their plain PyTorch
versions, and the wrappers (`ops`) the engine calls. A wrapper runs the
plain version for a CPU tensor and launches the kernel for a CUDA tensor;
it never falls back from one to the other."""
