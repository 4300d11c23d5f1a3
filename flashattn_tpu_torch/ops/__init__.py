"""Attention operators: the flash forward, flash-decode and the KV cache."""
