"""galah_tpu_torch: the PyTorch/CUDA port of galah-tpu.

Clusters genomes by average nucleotide identity (ANI) with the same
two-stage pipeline as ``galah_tpu`` (a skani-style, finch or dashing
precluster, exact fragment ANI on the precluster's pairs,
quality-ordered greedy selection), on an NVIDIA H100. The six kernels
that ``galah_tpu`` wrote in Pallas are hand-written CUDA C++ here
(``kernels/``); everything else is plain torch.

This package imports neither ``jax`` nor anything of ``galah_tpu``:
what it needs from there it keeps as its own copy. Every entry point
takes a ``device`` and defaults to ``cuda``; the CPU runs only when a
caller asks for it, and then with the kernels' plain torch versions.
"""

__version__ = "0.1.0"
