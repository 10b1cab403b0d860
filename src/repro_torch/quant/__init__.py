"""Hybrid data quantization (paper §2.3, Table 1)."""
