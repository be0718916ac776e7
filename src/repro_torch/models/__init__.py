"""Model stack of the port (dense family): layers, transformer, model."""
