"""Client API layer: local (embedded) and HTTP clients."""
