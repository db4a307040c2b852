"""Command-line models of the transmitters."""
