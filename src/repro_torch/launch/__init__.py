"""Launchers of the port (one device)."""
