"""Genome chunking and phase-aware ligation of per-chunk VCFs (ligate.py,
a copy of quilt_tpu/dist/ligate.py)."""
from .ligate import Chunk, ligate_vcfs, quilt_chunk_map

__all__ = ["Chunk", "ligate_vcfs", "quilt_chunk_map"]
