"""The benchmark's plain reference: multigrid cycles read from grammar tree
strings, the power iteration and its verdict, the staged solve's float64
residual and right-preconditioned BiCGStab, in plain PyTorch (float64 and
complex128 unless a caller asks for another dtype).

It is written from the problem definitions alone and imports nothing of the
programs under test: not `jax`, not `evostencils_tpu`, not `evostencils_torch`.
"""
