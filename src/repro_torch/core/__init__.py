"""The tracer's write path (record, finalize, encode, trace format) and its
read side (reader, ``TraceView`` queries, DFG, analyses, converters),
carried over from ``repro.core`` with dispatch pointed at the port's CUDA
kernels."""
