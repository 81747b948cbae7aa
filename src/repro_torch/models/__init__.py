"""Model stack of the port: layers, attention, the dense model, and the
weight bridge from the JAX package's parameter trees."""
