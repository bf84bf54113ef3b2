"""Optimizers and gradient compression of the port."""
