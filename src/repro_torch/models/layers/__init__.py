"""Layers of the LM stack: norms, rope, embeddings, mlp, moe, attention, mamba."""

# The full-sequence mixers' two implementations: the hand-written kernels
# ("cuda"; their plain versions on CPU tensors) or the plain versions on any
# device ("ref").
BACKENDS = ("cuda", "ref")
