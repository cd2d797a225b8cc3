"""raxtax_tpu_torch: the PyTorch/CUDA port of raxtax-tpu.

A k-mer based non-Bayesian taxonomic classifier (capability-compatible with
noahares/raxtax) whose device path runs on one NVIDIA Hopper GPU: the
postings fold, the intersection-size histogram, the per-tip probability
lookup and the sequential f64 prefix scan are hand-written CUDA kernels
(``csrc/``), everything around them is plain PyTorch, and the host layer
(FASTA, database, probability model, evaluation) is numpy plus the native
C++ helpers. The package imports neither JAX nor the JAX package it was
ported from; module names mirror that package so counterparts are easy to
find.
"""

__version__ = "0.1.0"
