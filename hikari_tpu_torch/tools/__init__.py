"""Measurement scripts of the port, run on the GPU with ``python3 -m``."""
