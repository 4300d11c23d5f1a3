"""Llama-style model, generation and the continuous-batching server."""
