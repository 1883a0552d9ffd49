"""Build and launch support for the CUDA kernels in ../csrc (build.py)."""
