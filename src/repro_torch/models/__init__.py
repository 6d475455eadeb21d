"""The language models of the LM host system (port of ``repro/models``):
plain functions on tensors over dict trees of parameters."""
