"""Depth-wise FeDepth core: memory model, decomposition, client update,
aggregation."""
