"""Training on one device: config, optimizers, steps, checkpoints, loop."""
