"""PyTorch / CUDA port of nsynth_wavenet_tpu for one NVIDIA H100.

The JAX package ``nsynth_wavenet_tpu`` is the reference; this package
mirrors its module names and imports nothing from it.  Importing the
package loads no torch, no CUDA toolchain and no kernel: the hand-written
CUDA kernels under ``csrc/`` are built by ``kernels/build.py`` at first use.
"""
