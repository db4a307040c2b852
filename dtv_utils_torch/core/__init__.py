"""Configuration, GF(2^m) tables, bit packing and the host IQ boundary."""
