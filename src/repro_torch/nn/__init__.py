"""Transformer building blocks of the LM stack."""
