"""Prompt helpers of the port."""
