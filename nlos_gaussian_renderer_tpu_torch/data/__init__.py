"""Synthetic scenes and scan grids."""
