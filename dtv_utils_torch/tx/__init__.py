"""Transmit chains."""
