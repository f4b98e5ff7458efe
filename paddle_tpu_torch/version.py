__version__ = "0.1.0"
full_version = __version__
major, minor, patch = 0, 1, 0
