"""Transformer primitives, token selection, sampling filters, sin-cos tables."""
