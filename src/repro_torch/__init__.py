"""PyTorch + CUDA port of the degree-separated distributed BFS engine.

Mirrors the layout of the reference JAX package ``repro`` module for
module, so each port module has one counterpart it is held against. The
port imports ``torch`` and ``numpy`` only. Entry points take ``device=``
and default to ``"cuda"``; without a card they raise unless the caller
passes ``device="cpu"``, which runs every kernel's plain PyTorch version.
"""
