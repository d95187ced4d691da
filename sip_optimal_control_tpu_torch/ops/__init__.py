"""Stagewise operators: tiny linear algebra, chain LQR, CUDA Riccati kernels,
KKT condensation."""
