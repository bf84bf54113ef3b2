"""Launchers of the port: train-step builders and the training CLI."""
