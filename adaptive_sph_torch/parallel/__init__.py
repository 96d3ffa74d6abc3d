"""Multi-device execution: the slab decomposition of the tile step."""
