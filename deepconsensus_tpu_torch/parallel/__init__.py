"""Attention over long windows (the blockwise ring scan)."""
