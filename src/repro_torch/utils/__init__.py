"""Framework-free utilities of the port: hardware specs."""
