"""The plain reference of the benchmark: GKGNet's forward (``model``) and
its training step (``train``: the dual loss, clipping, AdamW and the
warmup schedule), in plain PyTorch. It imports nothing of the program
under test and takes from it nothing but the outputs it judges."""
