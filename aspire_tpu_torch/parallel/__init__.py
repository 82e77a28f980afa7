"""Several ranks: process groups laid out as a mesh (parallel/mesh.py)."""
