"""Model stack of the port (the dense, ssm and hybrid families): layers,
the SSD and RG-LRU mixers, transformer, model."""
