"""Step builders (the serve step of this slice)."""
