"""PyTorch/CUDA port of the long-tail clustering system (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its
module names (``core.engine``, ``kernels.kmeans_assign``,
``models.transformer``, ``serving.serve_loop``, ...) so each counterpart
is easy to find.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; on a CPU tensor the kernel ops take their
plain PyTorch versions, on a CUDA tensor they launch the hand-written
kernels in ``kernels/csrc`` (built by ``kernels.build`` on first use).
"""
