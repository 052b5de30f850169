"""Device resolution, env flags, pytree walks and training metrics."""
