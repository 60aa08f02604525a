"""Measurement scripts of the port that need the card."""
