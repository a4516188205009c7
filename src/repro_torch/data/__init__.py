"""The paper's evaluation traces, drawn from a seed (counterpart of
``repro.data``)."""
