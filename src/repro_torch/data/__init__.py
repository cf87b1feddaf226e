"""Synthetic query stream and the byte tokenizer."""
