"""Engine layer: Collection orchestration, database/manager registries.
Host-side control plane over the device scan engine."""

from .collection import Collection, SearchResult  # noqa: F401
from .database import DatabaseEngine, DatabaseManager  # noqa: F401
