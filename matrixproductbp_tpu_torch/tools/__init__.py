"""Measurement scripts for the port on the card (run as ``python3 -m``)."""
