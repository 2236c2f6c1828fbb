"""Config, model, weights."""
