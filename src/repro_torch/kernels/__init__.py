"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``).

Nothing here is built or loaded at import: :mod:`repro_torch.kernels.build`
compiles a kernel the first time a CUDA tensor reaches its wrapper.
"""
