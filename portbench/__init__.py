"""The benchmark of the PyTorch and CUDA port (evostencils_torch): see run.py."""
