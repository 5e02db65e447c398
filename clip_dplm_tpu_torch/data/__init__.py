"""Protein tokenization and synthetic paired embeddings (numpy)."""
