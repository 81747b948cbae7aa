"""PyTorch/CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The package mirrors ``src/repro``'s layout module for module. It imports
``torch`` and nothing of JAX or of the ``repro`` package: what it needs
from framework-free modules (configs) it keeps as its own copy. Entry
points take an explicit ``device`` and default to ``"cuda"``; on a CUDA
tensor every kernel wrapper launches its hand-written Hopper kernel, on
a CPU tensor it runs the kernel's plain PyTorch version.
"""
