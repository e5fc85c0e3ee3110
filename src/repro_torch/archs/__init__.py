"""The LM stack's architecture schema and model (dense attention path)."""
