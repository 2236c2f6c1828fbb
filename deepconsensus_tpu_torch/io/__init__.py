"""BAM reading and writing."""
