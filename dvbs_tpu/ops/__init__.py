"""Device compute ops (JAX/XLA/Pallas): the hot kernels of the receive chain."""
