"""PyTorch + CUDA port of the dynamo-tpu serving engine for NVIDIA Hopper.

A package beside ``dynamo_tpu`` (the JAX reference). It imports torch,
numpy, pydantic and xxhash, and nothing of ``dynamo_tpu`` or JAX: what it
needs from the reference it keeps as its own copy, with the same module
paths, public names and array layouts, so tests can hold each function
against its JAX counterpart.

The three Pallas kernels of the reference are hand-written CUDA for
``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use
(``ops/_build.py``). Every kernel wrapper launches its kernel for CUDA
tensors and runs its plain PyTorch version only for CPU tensors.
"""
