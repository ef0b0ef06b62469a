"""Model code: layers, the dense decoder-only LM and the registry."""
