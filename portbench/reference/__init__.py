"""The plain reference: the models in f32 PyTorch, AdamW, a decoder of the
trace files, and the comparisons that decide ``correct``.  Nothing here
imports the port."""
