"""Host-side text featurization."""
