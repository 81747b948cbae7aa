"""Attention kernels of the port: split-KV flash decode."""
