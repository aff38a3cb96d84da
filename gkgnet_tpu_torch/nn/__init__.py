"""Model modules of the main path: backbone, head, losses."""
