"""Phred/sequence helpers."""
