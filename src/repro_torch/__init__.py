"""PyTorch/CUDA port of the Recorder tracer.

``repro_torch`` mirrors the layout and names of the JAX package ``repro``
(``core/...``, ``kernels/{delta_encode,grammar_stats}/...``) and writes
byte-identical traces, but imports ``torch`` instead of ``jax`` and never
imports ``repro``.  Its encode hot paths run hand-written CUDA kernels
(``kernels/csrc/*.cu``) on the card by default; the ``python``, ``numpy``
and ``torch`` backends of ``core.encode_backend`` run on the CPU.
"""
