"""The tracer's write path (record, finalize, encode, trace format) and the
trace reader, carried over from ``repro.core`` with dispatch pointed at the
port's CUDA kernels."""
