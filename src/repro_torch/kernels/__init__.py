"""Hand-written Hopper kernels of the encode hot paths.

Each package holds ``ops.py`` (the wrappers: checks, allocation, launch
and launch count) and ``ref.py`` (the plain PyTorch versions); the CUDA
sources live in ``csrc/`` and are built by ``_build.py`` at first use."""
