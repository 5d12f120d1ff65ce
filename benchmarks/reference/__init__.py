"""Plain NumPy and PyTorch references of the benchmark's jobs. Nothing here
imports cmtci, cmtci_torch or jax, and nothing takes what the port made."""
