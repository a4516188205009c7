"""Observability for the port: the null tracer (counterpart of ``repro.obs``)."""
