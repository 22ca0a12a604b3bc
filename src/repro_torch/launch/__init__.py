"""Launchers of the port's model stack (serving)."""
