"""Counterparts of the JAX package's kernel probes (its root tools/probes/
and tools/fan_probe.py): each probe's CUDA kernel, its plain PyTorch
version and a ``main`` that times them on the card."""
