"""Signal analyzers (PAPR/CCDF)."""
