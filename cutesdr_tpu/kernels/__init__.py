"""Pallas kernels for the hot front-end ops (GPU, through Triton).

Each kernel has a plain XLA reference implementation and equivalence tests
(interpret mode on the CPU); the receiver selects a kernel only where it
measured faster on the card (pipeline/receiver.resolve_front_end).
"""
