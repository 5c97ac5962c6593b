"""Models: the neural-image MLP and the planar graph."""
