"""Device operators: the RS bit-matrix encoder and the hand-written FIR kernel."""
