"""The mesh plane: a corpus sharded over several torch devices (parallel/mesh.py).

The process-wide default mesh lives here, below the engine: when it is set,
every new ``DeviceCorpus`` (ops/scan.py) shards its rows over the mesh's
corpus devices. This is how a Collection serves from a sharded corpus.
"""

_DEFAULT_MESH = None


def set_default_mesh(mesh) -> None:
    """Make every DeviceCorpus created from now on shard over ``mesh`` (a
    ``mesh.Mesh``), or over no mesh when None."""
    global _DEFAULT_MESH
    _DEFAULT_MESH = mesh


def get_default_mesh():
    return _DEFAULT_MESH
