"""Data parallelism across devices (`mesh.py`) and processes
(`multihost.py`)."""
