"""Miscellaneous tools: print a merged config, verify a dataset's images."""
