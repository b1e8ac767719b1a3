"""Selection, packing, threshold and kernel ops of the port."""
