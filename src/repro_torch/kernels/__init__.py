"""Hand-written CUDA kernels, with their plain PyTorch versions.

kmeans_assign    — fused k-means assignment + statistics
gmm_estep        — fused diagonal-GMM E-step + M-step sufficient statistics
flash_attention  — GQA attention forward (the LM prefill)

Each op package has ``ref.py`` (the plain version, used for CPU tensors and
as the kernel's yardstick) and ``ops.py`` (the wrapper: checks, launch on
the current stream and, for the clustering ops, the fixed-order reduction
of per-block partials).  The CUDA sources live in ``csrc/`` and are
compiled by ``build.py``.
"""
