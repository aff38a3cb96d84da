"""Deployment CLIs: export to a ``torch.export`` artifact, evaluate an
artifact, serve a checkpoint or an artifact over HTTP."""
