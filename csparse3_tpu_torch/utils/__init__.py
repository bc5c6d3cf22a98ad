"""Build helpers and interop with the JAX package's state."""
