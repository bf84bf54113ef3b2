"""PyTorch/CUDA port of the fabric-congestion characterization pipeline.

A second package beside ``repro`` (the JAX reference). It imports torch
and numpy only: nothing of JAX and nothing of ``repro``, whose modules it
mirrors file for file. Entry points run on the CUDA device unless the
caller passes ``device="cpu"``.
"""
