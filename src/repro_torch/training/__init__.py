"""The port's training path: AdamW, the Markov data, checkpoints and the
loop, twins of the JAX package's `training/`."""
