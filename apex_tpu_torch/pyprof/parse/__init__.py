from .parse import enrich  # noqa: F401
