"""Training of the port: the train step and the training loop."""
