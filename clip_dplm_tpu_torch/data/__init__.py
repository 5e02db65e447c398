"""Protein tokenization (numpy)."""
