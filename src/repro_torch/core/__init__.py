"""The analysis stack of the port: machine files, the µ-op trace IR of
an ATen program, its scheduling backends and the memory ladder."""
