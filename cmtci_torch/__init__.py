"""cmtci_torch — the CM-TCI correspondence pipeline on PyTorch and CUDA.

A port of the JAX package ``cmtci`` to PyTorch, with every TPU kernel of a
ported path rewritten by hand for NVIDIA Hopper (``csrc/``). It keeps
``cmtci``'s module paths and function names, so each counterpart is easy to
find, and it imports neither ``jax`` nor ``cmtci``.

Conventions:
  * plain functions on tensors; every public entry that touches a device
    takes an explicit ``device=`` ("cuda" raises when there is no card —
    nothing falls back to the CPU);
  * dtypes are passed every time (torch defaults to float32; the analysis
    math is float64 as in the reference);
  * randomness comes from the caller's ``np.random.RandomState`` stream, an
    explicit ``torch.Generator``, or a host draw of
    ``np.random.default_rng(seed)`` (the spectral bootstrap's resamples, the
    eigensolvers' start vector), so a CPU run and a card run draw alike.
"""

__version__ = "0.1.0"
