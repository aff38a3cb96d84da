"""The port's command-line tools (train, test, inference, deployment) and
measurement tools."""
