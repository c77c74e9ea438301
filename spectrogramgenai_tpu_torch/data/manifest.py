"""Class names from an image-folder tree (``spectrogramgenai_tpu/data/manifest.py``)."""

from __future__ import annotations

import os


def class_names_from_folder(root: str) -> list[str]:
    """Sorted subdirectory names (ImageFolder convention)."""
    return sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
