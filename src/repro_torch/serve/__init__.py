"""Serving: slot-based continuous batching over the LM (counterpart of
``repro.serve``)."""
