"""Data parallelism over ``torch.distributed`` and sequence tiling
(counterpart of the JAX package's ``parallel/``)."""
