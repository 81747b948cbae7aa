"""Training and serving steps of the port (counterpart of
``repro.train``)."""
