"""Bad fixture: the JAX package's side, outside the port's package: its
read of jax_only does not wire the port's field, and its sync is not the
port's to flag."""


def step(serve, x):
    return serve.jax_only + x.item()
