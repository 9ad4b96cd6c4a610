"""Dense-side models."""
