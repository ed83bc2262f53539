"""PyTorch port of plankassembly_tpu for NVIDIA GPUs (hand-written CUDA kernels)."""
