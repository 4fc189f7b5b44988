"""Multi-device serving: the data-parallel mesh (parallel/mesh.py)."""
