"""Stitching windows into reads."""
