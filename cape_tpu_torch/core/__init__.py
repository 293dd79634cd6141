"""Configuration, parameter initializers and the JAX parameter bridge."""
