"""The benchmark's plain reference: function A (``registration``) and the
composition of rigid deformations (``compose``) in plain PyTorch.  Imports
nothing of the program, of ``repro`` or of ``jax``."""
