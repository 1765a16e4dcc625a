"""The LM stack of the port: layers and the unified LM (dense family)."""
