"""Model layers, ported as the slices that run them land."""
