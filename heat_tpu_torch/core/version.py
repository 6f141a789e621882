"""Version information (counterpart of heat_tpu/core/version.py): a
major/minor/micro/extension split, as the reference's
heat/core/version.py:1-16."""

major: int = 0
"""Major version number."""
minor: int = 1
"""Minor version number."""
micro: int = 0
"""Micro version number."""
extension: str = "dev"
"""Extension tag."""

__version__ = f"{major}.{minor}.{micro}-{extension}" if extension else f"{major}.{minor}.{micro}"
