"""Dataset conversion: the COCO multi-label pickle from instances JSON."""
