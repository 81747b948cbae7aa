"""The paper's tables and figures on the port: one module each, run by
``python -m repro_torch.bench.run`` (see ``run.py``)."""
