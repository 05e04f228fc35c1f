"""Decoder-only language models of the port (dense family)."""
