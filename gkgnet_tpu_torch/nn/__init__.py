"""Model modules (eval forward of the main path)."""
