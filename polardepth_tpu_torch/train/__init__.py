"""Training and serving of the port: the steps, the training loop and
checkpoints."""
