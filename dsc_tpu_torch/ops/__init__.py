"""Elementwise op kernels."""
