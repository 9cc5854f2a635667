"""Multi-device and multi-host execution: the device mesh and the
panel-sharded FB (mesh.py), sample shards across processes (hosts.py), and
genome chunking with phase-aware ligation of per-chunk VCFs (ligate.py, a
copy of quilt_tpu/dist/ligate.py)."""
from .ligate import Chunk, ligate_vcfs, quilt_chunk_map
from .mesh import fb_full_sharded, make_mesh

__all__ = ["Chunk", "fb_full_sharded", "ligate_vcfs", "make_mesh", "quilt_chunk_map"]
