"""Visualizations: label->patch edges, class activation and saliency maps,
the learning-rate schedule, augmented samples."""
