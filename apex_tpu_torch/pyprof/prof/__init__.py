from .prof import analyze_rows  # noqa: F401
