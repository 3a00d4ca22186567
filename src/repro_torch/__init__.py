"""PyTorch/CUDA port of the ``repro`` serving stack, for NVIDIA Hopper.

Same layout as ``repro`` (``configs``, ``kernels``, ``models``,
``serve``), with the TPU kernels rewritten as hand-written CUDA kernels
under ``kernels/csrc`` and a plain PyTorch version of each beside it.
The package imports torch, numpy and the standard library only.
"""
