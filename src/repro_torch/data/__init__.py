"""Training data sources (counterpart of ``repro.data``)."""
