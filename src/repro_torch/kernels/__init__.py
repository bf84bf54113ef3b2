"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions
(``ref``) and the device dispatch (``ops``)."""
