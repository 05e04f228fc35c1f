"""Training data of the port: the JAX package's seeded synthetic tokens."""
