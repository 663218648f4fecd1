"""The `@hot_path` marker and the runtime sanitizer (`sanitize`), copied
from the reference package."""
from .hotpath import hot_path, is_hot_path

__all__ = ["hot_path", "is_hot_path"]
