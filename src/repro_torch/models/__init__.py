"""The LM stack of the port: layers, the Mamba block, the decoder LM and
``build_model``."""
