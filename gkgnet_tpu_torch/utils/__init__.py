"""Weight loading from the JAX package's variable tree."""
