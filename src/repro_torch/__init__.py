"""PyTorch and CUDA port of the Mirovia/Altis suite for NVIDIA Hopper.

Mirrors ``repro`` path for path and imports nothing of it (nor JAX): the
JAX package is the reference the port is held against, in the tests only.
"""
