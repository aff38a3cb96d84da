"""The port's command-line tools (train, test, inference, deployment),
measurement tools, and the groups ported from the JAX package's
``tools/``: analysis_tools, visualizations, misc, convert_data and
convert_models."""
