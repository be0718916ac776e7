"""The port's math references: k-means routing, local, full and routed
attention in plain PyTorch."""
