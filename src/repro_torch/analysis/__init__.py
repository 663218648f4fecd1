"""tentlint for the port: static analysis plus the runtime sanitizer.

This package only eagerly exposes the `@hot_path` marker (imported by hot
engine modules, so it must stay dependency-free and instant); the linter
(`repro_torch.analysis.lint`), its rules (`.rules`), core (`.core`),
baseline (`.baseline`) and the runtime sanitizer (`.sanitize`) are
imported on demand. See README.md beside this file.
"""
from .hotpath import hot_path, is_hot_path

__all__ = ["hot_path", "is_hot_path"]
