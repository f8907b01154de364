"""PyTorch/CUDA port of ``relightableavatar_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's module layout and function names and
imports nothing of it (nor JAX).  Its one hand-written kernel is the exact
top-3 KNN (``ops/knn_cuda.py`` + ``csrc/knn_top3.cu``); everything else is
plain PyTorch.
"""
