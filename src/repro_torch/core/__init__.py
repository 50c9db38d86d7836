"""Paper-faithful encoding / quantization / MCAM / AVSS model in PyTorch."""
