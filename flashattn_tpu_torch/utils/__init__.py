"""Verification and timing helpers."""
