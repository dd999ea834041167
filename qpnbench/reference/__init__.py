"""The benchmark's plain reference: each model's statement in NumPy, the
residual check, and a plain Lemke solve in PyTorch.  Imports nothing of the
program."""
