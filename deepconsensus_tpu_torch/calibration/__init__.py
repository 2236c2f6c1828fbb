"""Base-quality calibration."""
