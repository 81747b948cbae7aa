"""The paper's streaming kernel suite: plain versions (``ref``), the CUDA
kernels' wrappers (``kernels``) and the impl- and flavor-routed public
entry points (``ops``)."""
