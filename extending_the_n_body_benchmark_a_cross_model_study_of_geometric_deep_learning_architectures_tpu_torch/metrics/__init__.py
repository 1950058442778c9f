"""Macro statistics and KS / Fisher scoring."""
