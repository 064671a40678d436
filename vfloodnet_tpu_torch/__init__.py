"""flowtide video and image water segmentation and water level from a
reference object, in PyTorch and CUDA.

The port of :mod:`vfloodnet_tpu` to one NVIDIA H100. The JAX package stays
beside it as the reference that every module here is tested against
(``tests/test_torch_*.py``). This package imports ``torch``, ``numpy`` and
``scipy`` only (PIL, OpenCV, pandas and matplotlib inside the functions
that read, write or draw); the memory read and usage count over the
feature bank (``csrc/bank_read.cu``, ``csrc/bank_read_bf16.cu``) and the
largest connected component (``csrc/cc.cu``) are hand-written CUDA
kernels, built with ``nvcc`` at first use. On the card the video step is
replayed as a CUDA graph.

Layout mirrors the JAX package: ``core`` (weights), ``ops``, ``models``,
``memory`` (the feature bank), ``pipelines`` (the video and image
engines, the water-level pipelines and their CLIs), and ``data`` and
``train`` (the AFB-URR trainer and its CLI).
Entry points run on ``device="cuda"`` unless the caller passes another
device; they raise when CUDA is absent.
"""
