"""DawnSearch on PyTorch and CUDA: the port of `dawnsearch_tpu`.

A second package beside the JAX reference, with the same layout and
public names. It serves a text query end to end — WordPiece tokenize,
MiniLM encoder (hand-written whole-layer CUDA kernel, K1), fused i8
score+select over a device-resident FlatIndex (hand-written CUDA kernel,
K2), f32 re-rank, SQLite store join — and ingests pages the same way.
CUDA sources are in csrc/ and build with nvcc at first use
(ops/_cuda.py); on CPU tensors every kernel wrapper runs its plain
PyTorch version. It also ingests WARC files (ingest/) and joins the P2P
swarm over UDP (net/), with the reference's wire formats. This package
never imports JAX or `dawnsearch_tpu`, and importing it loads no torch:
the spawned extraction workers import only its host modules.
"""

__version__ = "0.1.0"
