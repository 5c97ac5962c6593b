"""Host-side datasets."""
