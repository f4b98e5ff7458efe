"""Utilities of the distributed tier: the collectives' watchdog."""
