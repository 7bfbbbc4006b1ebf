"""Engine error types (reference: src/error.rs:1-73).

LynseError derives from RuntimeError because the reference's Python binding
maps every engine error to RuntimeError (src/python/mod.rs:828
PyRuntimeError::new_err), and the reference test-suite asserts
``pytest.raises(RuntimeError, match="read-only")`` — code written against
the reference must keep working unchanged."""


class LynseError(RuntimeError):
    pass


class DimensionMismatch(LynseError):
    pass


class CollectionNotFound(LynseError):
    pass


class DatabaseNotFound(LynseError):
    pass


class IndexNotBuilt(LynseError):
    pass


class InvalidArgument(LynseError, ValueError):
    pass


class ReadOnly(LynseError):
    pass


class CollectionClosed(LynseError):
    """Operation attempted on a collection handle after close()."""


import re as _re


def validate_resource_name(name: str) -> str:
    """Reject path traversal in db/collection names
    (reference: engine.rs:62-90)."""
    if not name or len(name) > 255:
        raise InvalidArgument(f"invalid resource name: {name!r}")
    if not _re.fullmatch(r"[A-Za-z0-9_\-\.]+", name) or name in (".", "..") or name.startswith("."):
        raise InvalidArgument(f"invalid resource name: {name!r}")
    return name
