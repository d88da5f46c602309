"""PyTorch/CUDA port of the Recorder tracer.

``repro_torch`` mirrors the layout and names of the JAX package ``repro``
(``core/...``, ``kernels/{delta_encode,grammar_stats}/...``,
``traceserve/...``, ``launch/traceserve.py``), writes byte-identical
traces and answers read-side queries with the same values, but imports
``torch`` instead of ``jax`` and never imports ``repro``.  Its encode and
read hot paths run hand-written CUDA kernels (``kernels/csrc/*.cu``) on
the card by default; the ``python``, ``numpy`` and ``torch`` backends of
``core.encode_backend`` run on the CPU.
"""
