"""Runtimes of the port: the batched LM server, the trainer and its fault
handling."""
