"""Serving of the port: caches, prefill and single-token decode."""
