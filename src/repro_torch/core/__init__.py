"""Paper algorithms on tensors: range partitioning, MergeMarathon, runs and
the run arena, and the server merges (counterpart of ``repro.core``)."""
