"""Launchers of the port: the LM serving steps and the serving CLI."""
