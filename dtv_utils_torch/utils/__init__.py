"""Device selection, metric lines and CUDA-event timing."""
