"""Training: state, steps, checkpoints and the `Trainer`."""
