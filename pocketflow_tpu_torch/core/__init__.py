"""Core services: schedules, metrics, checkpoints and the bridge from JAX parameters."""
