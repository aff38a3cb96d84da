"""Analysis tools: re-score a test CLI's --out file, rank its images, read
a training log, count FLOPs and parameters."""
