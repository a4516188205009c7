"""Training of the port (counterpart of ``repro.train``): AdamW on tensors,
the microbatched train step and atomic, resumable checkpoints."""
