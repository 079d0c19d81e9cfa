"""Hand-written CUDA kernels for the clustering hot loop, with their plain
PyTorch versions.

kmeans_assign  — fused k-means assignment + statistics
gmm_estep      — fused diagonal-GMM E-step + M-step sufficient statistics

Each op package has ``ref.py`` (the plain version, used for CPU tensors and
as the kernel's yardstick) and ``ops.py`` (the wrapper: checks, launch on
the current stream, the fixed-order reduction of per-block partials).  The
CUDA sources live in ``csrc/`` and are compiled by ``build.py``.
"""
