"""Featurization: alignment expansion, spacing, windowed pileups."""
