"""Launch entry points of the port (``serve``, ``train``) and the fault
helpers (``faults``)."""
