"""PyTorch/CUDA port of ``vtc_tpu`` for one NVIDIA H100.

The layout mirrors the JAX package (``ops``, ``models``, ``data``,
``serving``) so each module's counterpart is easy to find. The package
imports ``torch``, ``numpy`` and the standard library; ``triton`` is imported
only inside the functions that launch a Triton kernel, and the CUDA C++
kernels under ``csrc/`` are compiled with ``nvcc`` at first use
(``ops/_build.py``).

Entry points (``models.create_model``, ``serving.ClipRetrievalService``) run
on ``cuda`` unless the caller passes ``device="cpu"``; without a card and
without an explicit device they raise.
"""
