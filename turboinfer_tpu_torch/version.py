"""Version of the port (the JAX package's version.py: plain module
constants)."""

MAJOR = 0
MINOR = 1
PATCH = 0

__version__ = f"{MAJOR}.{MINOR}.{PATCH}"


def version_string() -> str:
    return __version__
