"""Host-side durability plane: segmented vector storage, WAL, ID maps,
tombstones, metadata field store. This layer is I/O, not compute — the
device-side scan engine lives in :mod:`lynsedb_tpu_torch.ops`."""
